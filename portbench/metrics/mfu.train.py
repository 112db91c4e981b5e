"""The training update's share of the cards' float32 peak (67 TFLOP/s a
card, times the cards the cell uses): the FLOPs of the window's updates,
counted from the configuration's widths (`counts/work.py`: the policy's
forward pass on every rollout sample, its forward and backward pass on
every sample of every epoch, the env steps' physics) for the global
batch, over the wall time of the untraced window of a traced run."""

PEAK = 67e12


def read(ctx):
    wall = ctx.get("window_wall_s")
    if not wall:
        return None
    return 100.0 * ctx["update_flops"] * ctx["updates_window"] / wall \
        / (PEAK * ctx["cards"])
