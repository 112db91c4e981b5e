"""Host milliseconds of an update's GAE (and, under sb3 minibatching, its
gather): the mean duration of the program's `ppo.gae` span over a window
of updates recorded on the host's clock, with no profiler and no
synchronize (`portbench/program.py`)."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_spans", "ppo.gae")
    return None if got is None else 1e3 * got["total_s"] / got["count"]
