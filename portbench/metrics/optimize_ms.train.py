"""Milliseconds of an update's minibatch steps (loss, gradient, clip,
Adam): the median of the harness's host-clock span from the update's
`after_rollout` hook to the readback of its metrics."""
import statistics


def read(ctx):
    spans = ctx.get("optimize_s")
    return 1e3 * statistics.median(spans) if spans else None
