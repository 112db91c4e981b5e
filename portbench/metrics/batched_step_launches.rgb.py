"""Device operations launched a control step by `make_batched_step`'s
`step_fn`: the operations whose launch lies inside the program's
`env.batched_step` spans in the profiled window of updates, over those
spans, one a control step (`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "env.batched_step")
    return None if got is None else got["ops"] / got["spans"]
