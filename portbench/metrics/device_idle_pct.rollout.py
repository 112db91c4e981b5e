"""The share of the traced window in which no operation ran on the
device: 1 - the union of the device operations' intervals over the
window (`torch.profiler`)."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device or trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us() / trace.window_us)
