"""The share of `make_batched_step`'s control steps that ran as the
replay of a CUDA graph: the summed `graphed` attribute of the program's
`env.batched_step` spans over a window of updates recorded on the host's
clock, with no profiler and no synchronize, over those spans
(`portbench/program.py`).  A program whose spans carry no such attribute
reports nothing."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "env.batched_step")
    if got is None or "graphed" not in got["attrs"]:
        return None
    return got["attrs"]["graphed"] / got["count"]
