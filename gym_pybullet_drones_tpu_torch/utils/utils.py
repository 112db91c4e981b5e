"""General utilities: wall-clock pacing, argparse helpers, and the import
of an optional package.

Own copy of the JAX package's `utils/utils.py` (parity: the reference's
gym_pybullet_drones/utils/utils.py:10-54).
"""
from __future__ import annotations

import argparse
import importlib
import time


def sync(i: int, start_time: float, timestep: float) -> None:
    """Sleep so that iteration i lands on the wall-clock schedule.

    Used by GUI example loops to pace simulation to real time (reference
    utils.py:10-29); only engages for timesteps above ~3 ms like the
    reference.
    """
    if timestep > 0.04 or i % (int(1 / (24 * timestep))) == 0:
        elapsed = time.time() - start_time
        if elapsed < (i * timestep):
            time.sleep(timestep * i - elapsed)


def str2bool(val) -> bool:
    """Parse a boolean CLI flag (reference utils.py:33-54)."""
    if isinstance(val, bool):
        return val
    if val.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if val.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("[ERROR] in str2bool(), a Boolean value is required")


def require(module: str, purpose: str):
    """Import the optional package `module` that `purpose` needs, or raise
    an ImportError that names it.  matplotlib and PIL draw and write the
    images and plots; nothing else of the package needs them."""
    try:
        return importlib.import_module(module)
    except ImportError as err:
        raise ImportError(f"{purpose} needs the package '{module}', which "
                          "is not installed") from err
