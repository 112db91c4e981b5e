"""Host milliseconds of one call of the fused env step's wrapper
(`ops/kernel_fused.fused_env_step`: its checks, the `FusedSpec` lookup
behind `_step_params`, two `torch.empty` and the ctypes launch): the
mean duration of the program's `kernel.fused_env_step` span over a window
of chunks recorded on the host's clock, with no profiler
(`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "kernel.fused_env_step")
    return None if got is None else 1e3 * got["total_s"] / got["count"]
