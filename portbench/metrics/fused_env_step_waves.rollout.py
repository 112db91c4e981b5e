"""Waves of the fused env step's launch: its blocks over the blocks that
all SMs of the card hold at once, as the wrapper
(`ops/kernel_fused.fused_env_step`) computes it from the CUDA runtime's
occupancy for the kernel as built; the summed `waves` attribute of the
program's `kernel.fused_env_step` spans over a window of chunks recorded
on the host's clock, with no profiler (`portbench/program.py`), over
their count.  At most 1, every block of a launch runs in the first wave.
A program whose spans carry no such attribute reports nothing."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "kernel.fused_env_step")
    if got is None or "waves" not in got["attrs"]:
        return None
    return got["attrs"]["waves"] / got["count"]
