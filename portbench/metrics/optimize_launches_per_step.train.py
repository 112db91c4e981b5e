"""Device operations launched an optimizer step of the training update:
the operations whose launch lies inside the program's `ppo.optimize`
spans in a profiled window of updates, over (those spans x
`optimize_steps`, the epochs times the minibatches)
(`portbench/program.py`).  The launches a CUDA graph of the minibatch
step would take away."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "ppo.optimize")
    steps = ctx.get("optimize_steps")
    if got is None or not steps:
        return None
    return got["ops"] / (got["spans"] * steps)
