"""The whole rollout step's share of the card's peak: the least time the
traced window's env steps need (`counts/work.py`, as for
`fused_env_step_roofline`) over the traced window's wall time."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or trace.window_us <= 0:
        return None
    return 100.0 * ctx["bound_s_per_step"] * ctx["env_steps_traced"] \
        / (trace.window_us / 1e6)
