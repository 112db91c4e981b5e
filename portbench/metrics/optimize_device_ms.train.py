"""Device milliseconds an update's optimizer phase keeps the card busy:
the summed device time of the operations launched inside the program's
`ppo.optimize` spans in a profiled window, over those spans
(`portbench/program.py`).  The floor that a graphed optimizer phase
approaches."""
from portbench import program


def read(ctx):
    got = program.record(ctx, "program_trace", "ppo.optimize")
    if got is None or not got["ops"]:
        return None
    return 1e3 * got["device_s"] / got["spans"]
