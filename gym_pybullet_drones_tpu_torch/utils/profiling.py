"""Profiling: the program's spans, a trace of a section, and a steps/s
measurement.

`span(name, **attrs)` marks one piece of the program's work (an update's
phases in `rl/ppo.py`, the fused and the batched env step in
`envs/fast.py`, the kernel wrappers `ops/kernel_fused.py`,
`ops/kernel_dyn.py` and `ops/kernel_render.py`, the collectives in
`parallel/mesh.py`).  It has
three states, and nothing but the code around it chooses among them:

- off (the default): `span` returns one shared no-op object; no clock is
  read, nothing is recorded;
- under an active `torch.profiler` session (`trace` below, or any other):
  the span is a `record_function` range, a `user_annotation` in the same
  trace as the device's kernels and on the profiler's one clock, so each
  device operation can be put down to the span that launched it;
- inside `recording()`: the span is also recorded on the host's clock
  (`time.perf_counter_ns`) into the `Record` that `recording()` yields:
  aggregates per name (count, total and self seconds, the sum of each
  numeric attribute) and a ring of the latest `RING_CAPACITY` raw spans,
  so memory does not grow with the window.

A span never synchronizes and never reads the device: its attributes
are values the host already holds (a byte count from the shape).  Spans
nest within one thread; a record serves the thread that opened it.

`trace` captures a `torch.profiler` trace (host operators, the program's
spans, and the card's kernels where there is a card) and writes it as a
Chrome trace that Perfetto opens; `measure_steps_per_sec` times a step
function with a host readback inside each timed iteration, so that the
window ends when the device's work does (a launch returns before its
kernel runs).
"""
from __future__ import annotations

import collections
import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile

# the raw spans a record keeps, the latest ones; the aggregates count all
RING_CAPACITY = 4096

_clock = time.perf_counter_ns
_record = None          # the open Record, if any


class _Off:
    """The span of the off state: one shared object that does nothing.

    Its `__enter__` and `__exit__` are `object.__init__`, which takes and
    ignores any arguments on a type that defines `__new__` and not
    `__init__`, and returns None: a `with` on it runs no Python frame
    (about a fifth of the off state's cost) and lets every exception
    through."""

    __slots__ = ()
    __enter__ = __exit__ = object.__init__

    def __new__(cls):
        return object.__new__(cls)


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "_range", "_record", "_frame")

    def __init__(self, name, attrs, record):
        self.name, self.attrs, self._record = name, attrs, record
        self._range = self._frame = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self._record is not None:
            self._frame = self._record._open(self.name)
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            self._record._close(self._frame, self.attrs)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager around one piece of the program's work (see the
    module docstring); `attrs` are numbers the host already holds, summed
    per name in a record.  `with span(...) as sp` gives None when off and
    the span otherwise, whose `attrs` dict takes more of them until it
    closes."""
    if _record is None and not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name, attrs, _record)


class Record:
    """What `recording()` keeps: `spans`, a ring of the latest
    `RING_CAPACITY` spans as (name, parent name or None, start_ns,
    end_ns, attrs); `summary()`, the aggregates of every span."""

    def __init__(self):
        self.spans = collections.deque(maxlen=RING_CAPACITY)
        # name -> [count, total_ns, self_ns, {attr: sum}]
        self._totals = {}
        # the open spans' [name, start_ns, children_ns], innermost last
        self._open_frames = []

    def _open(self, name):
        frame = [name, 0, 0]
        self._open_frames.append(frame)
        frame[1] = _clock()
        return frame

    def _close(self, frame, attrs):
        end = _clock()
        name, start, children = frame
        frames = self._open_frames
        frames.pop()
        dur = end - start
        parent = frames[-1] if frames else None
        if parent is not None:
            parent[2] += dur
        agg = self._totals.get(name)
        if agg is None:
            agg = self._totals[name] = [0, 0, 0, {}]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - children
        for k, v in attrs.items():
            agg[3][k] = agg[3].get(k, 0) + v
        self.spans.append((name, None if parent is None else parent[0],
                           start, end, attrs))

    def summary(self) -> dict:
        """{name: {"count", "total_s", "self_s", "attrs": {attr: sum}}}
        over every span closed in the record; self time is a span's
        duration less what its child spans cover."""
        return {name: {"count": c, "total_s": t / 1e9, "self_s": s / 1e9,
                       "attrs": dict(a)}
                for name, (c, t, s, a) in self._totals.items()}


@contextlib.contextmanager
def recording():
    """Record every span of the `with` block (this thread's); yields the
    `Record`.  A recording inside another records into the inner one
    until it closes."""
    global _record
    outer, _record = _record, Record()
    try:
        yield _record
    finally:
        _record = outer


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
