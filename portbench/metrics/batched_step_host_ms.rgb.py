"""Host milliseconds of one call of `make_batched_step`'s `step_fn` (the
action's ring push, the rpm mapping, K1's wrapper and launch, the render
wrapper and launch, the reward and flags, the auto-reset's selects): the
mean duration of the program's `env.batched_step` span over a window of
updates recorded on the host's clock, with no profiler and no
synchronize (`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "env.batched_step")
    return None if got is None else 1e3 * got["total_s"] / got["count"]
