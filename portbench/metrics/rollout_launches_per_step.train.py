"""Device operations launched a rollout step of the training update: the
operations whose launch lies inside the program's `ppo.rollout` spans in
a profiled window of updates, over (those spans x `rollout_steps`)
(`portbench/program.py`).  The launches a CUDA graph of the rollout step
would take away."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "ppo.rollout")
    steps = ctx.get("rollout_steps")
    if got is None or not steps:
        return None
    return got["ops"] / (got["spans"] * steps)
