"""The share of the training update's optimizer steps that ran as the
replay of a CUDA graph: the summed `graph_steps` attribute of the
program's `ppo.optimize` spans over a window of updates recorded on the
host's clock, with no profiler and no synchronize, over (those spans x
`optimize_steps`, the epochs times the minibatches)
(`portbench/program.py`).  A program whose spans carry no such attribute
reports nothing."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "ppo.optimize")
    steps = ctx.get("optimize_steps")
    if got is None or not steps or "graph_steps" not in got["attrs"]:
        return None
    return got["attrs"]["graph_steps"] / (got["count"] * steps)
