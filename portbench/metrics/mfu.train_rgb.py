"""The pixel training update's share of the card's float32 peak (67
TFLOP/s): the FLOPs of the window's updates, counted from the
configuration's shapes (`counts/pixels.py`: the NatureCNN's forward pass
on every rollout sample and the last observation, its forward and
backward pass on every sample of every epoch, each control step's render
and DYN step), over the wall time of the untraced window of a traced
run."""

PEAK = 67e12


def read(ctx):
    wall = ctx.get("window_wall_s")
    if not wall:
        return None
    return 100.0 * ctx["update_flops"] * ctx["updates_window"] / wall / PEAK
