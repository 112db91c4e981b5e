"""A step as CUDA graphs with its hand-written kernels launched eagerly
between them, and the step's constants on a device.

`Segments` captures a step on the current stream.  Each hand-written
kernel's wrapper hands its launch to `launch`: outside a capture that
runs the launch at once; inside one it ends the graph captured so far,
keeps the launch and starts the next graph.  A replay then replays the
first graph, runs the first launch, replays the second graph, and so
on, all on the current stream.  So the step's glue costs one host
launch a segment, while each kernel keeps its wrapper's span and its
`launches` count on every step, as an eager step has them.

A graph reads its inputs by address: a constant that the step copies
from the host on every call cannot be captured, and one that is freed
after the capture is read from freed memory.  `constant` makes each
once per device and dtype, and a capture keeps those its step used.
"""
from __future__ import annotations

import functools
import warnings

import torch

_capture = None  # the `Segments` being captured, if any


def launch(go) -> None:
    """Run `go`, one hand-written kernel's launch on the current stream
    (its span, the call, its wrapper's `launches`).  Inside a `Segments`
    capture the launch does not run: the capture ends its graph there,
    and each replay runs `go` before the next graph."""
    if _capture is None:
        go()
    else:
        _capture.split(go)


@functools.cache
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype, device) -> torch.Tensor:
    """`values` (a number or nested tuples of numbers) as a tensor of
    `dtype` on `device`, made once and then shared by every caller; a
    `Segments` capture that reads it keeps it.  Never write to it."""
    t = _constant(values, dtype, device)
    if _capture is not None:
        _capture.held.append(t)
    return t


class Segments:
    """`with Segments() as seg: step()` captures `step` on the current
    (side) stream; `seg.replay()` runs it again on the current stream.
    The graphs share one memory pool, whose tensors the step's results
    keep; `held` keeps the constants the step read."""

    def __init__(self):
        self.steps = []     # graph replays and kernel launches, in order
        self.held = []
        self._pool = None
        self._graph = None

    def __enter__(self):
        global _capture
        if _capture is not None:
            raise RuntimeError("a Segments capture is already open")
        torch.cuda.synchronize()
        self._pool = torch.cuda.graph_pool_handle()
        self._begin()
        _capture = self
        return self

    def __exit__(self, exc_type, *exc):
        global _capture
        _capture = None
        try:
            self._end()
        except RuntimeError:
            # a capture the step's own error broke: that error propagates
            if exc_type is None:
                raise
        return False

    def split(self, go) -> None:
        self._end()
        self.steps.append(go)
        self._begin()

    def replay(self) -> None:
        for step in self.steps:
            step()

    def _begin(self) -> None:
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self._pool)

    def _end(self) -> None:
        """End the open graph; keep it unless it holds nothing (two
        kernels with nothing between them)."""
        graph, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in said:
            if "Graph is empty" in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if not empty:
            self.steps.append(graph.replay)
