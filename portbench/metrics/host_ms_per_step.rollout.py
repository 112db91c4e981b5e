"""Host milliseconds a control step spends in `make_fused_rollout`'s
`step_fn` (the action transpose, the kernel's launch, `unpack_outs`):
the mean of the harness's host-clock spans around each call, with no
synchronize, over the untraced window of a traced run."""


def read(ctx):
    spans = ctx.get("host_step_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
