"""The render kernel's share of its roofline: the least time the card
could take for the profiled window's renders (`counts/pixels.py`: the
greater of their float32 operations, 420 a pixel, over 67 TFLOP/s and
their bytes over 3.35 TB/s, at the cell's cameras a launch) over the
device time of the operations launched inside the program's
`kernel.render` spans (`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "kernel.render")
    if got is None or got["device_s"] <= 0:
        return None
    return 100.0 * ctx["render_bound_s"] * got["spans"] / got["device_s"]
