"""The share of the traced updates' window in which no operation ran on
the device: 1 - the union of the device operations' intervals over the
window (`torch.profiler`), averaged over the ranks."""


def read(ctx):
    share = ctx.get("device_idle_share")
    return None if share is None else 100.0 * share
