"""Device operations launched a control step by `make_fused_rollout`'s
`step_fn`: the operations whose launch lies inside the program's
`env.fused_step` spans in the traced window, over the env steps traced
(`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "env.fused_step")
    steps = ctx.get("env_steps_traced")
    if got is None or not steps:
        return None
    return got["ops"] / steps
