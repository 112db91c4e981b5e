"""Profiling: a trace of a section, and a steps/s measurement.

Counterpart of the JAX package's `utils/profiling.py`: `trace` captures a
`torch.profiler` trace (host operators, and the card's kernels where there
is a card) and writes it as a Chrome trace that Perfetto opens;
`measure_steps_per_sec` times a step function with a host readback inside
each timed iteration, so that the window ends when the device's work
does (a launch returns before its kernel runs).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the `with` block; writes `log_dir/trace.json` and yields
    the profiler (its `key_averages()` sums by operator and kernel)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _readback(state):
    """Sum of the first floating tensor in `state` (a tensor, or tuples,
    lists and dicts of them), read on the host; None if it holds none."""
    if isinstance(state, torch.Tensor):
        return float(state.sum()) if state.is_floating_point() else None
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (tuple, list)):
        for x in state:
            got = _readback(x)
            if got is not None:
                return got
    return None


def measure_steps_per_sec(step_fn, state, n_iters: int = 5,
                          steps_per_iter: int = 1):
    """Best-of-`n_iters` rate of `step_fn(state) -> state`, in steps a
    second, and the last state.  One warm-up call first (kernel builds,
    first-call costs); each timed call ends in a host readback of its
    result's first floating tensor."""
    state = step_fn(state)
    if _readback(state) is None:
        raise ValueError("step_fn's result holds no floating tensor to "
                         "read back")
    best = 0.0
    for _ in range(n_iters):
        t0 = time.perf_counter()
        state = step_fn(state)
        _readback(state)
        best = max(best, steps_per_iter / (time.perf_counter() - t0))
    return best, state
