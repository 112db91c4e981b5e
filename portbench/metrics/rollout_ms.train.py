"""Milliseconds of an update's rollout and GAE: the median over the
untraced window of a traced run of the harness's host-clock span from the
update's call to its `after_rollout` hook, which synchronizes."""
import statistics


def read(ctx):
    spans = ctx.get("rollout_s")
    return 1e3 * statistics.median(spans) if spans else None
