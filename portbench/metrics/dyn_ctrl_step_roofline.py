"""The DYN step kernel's (K1's) share of its roofline: the least time the
card could take for the profiled window's DYN steps (`counts/pixels.py`:
the greater of their float32 operations over 67 TFLOP/s and their 33 rows
a column x 4 bytes over 3.35 TB/s, at the cell's columns a launch) over
the device time of the operations launched inside the program's
`kernel.dyn_ctrl_step` spans (`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "kernel.dyn_ctrl_step")
    if got is None or got["device_s"] <= 0:
        return None
    return 100.0 * ctx["dyn_bound_s"] * got["spans"] / got["device_s"]
