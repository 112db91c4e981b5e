"""The fused env step's share of its roofline: the least time the card could
take for the traced window's env steps (from `counts/work.py`: the
greater of their float32 operations over 67 TFLOP/s and their bytes over
3.35 TB/s) over the device time of every operation launched inside the
harness's env-step spans, whatever its name."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    ops = trace.launched_in("portbench.env_step")
    device_s = sum(b - a for _, a, b in ops) / 1e6
    if device_s <= 0:
        return None
    return 100.0 * ctx["bound_s_per_step"] * ctx["env_steps_traced"] \
        / device_s
