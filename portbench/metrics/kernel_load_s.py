"""Seconds the process's first `_build.load()` took as a whole: the
build of the CUDA libraries (nothing where the checkout has them
already) and the five `ctypes` loads with their struct checks
(`_build.load_seconds`, a counter of the program)."""
from portbench import program


def read(ctx):
    return program.context(ctx).get("kernel_load_s")
