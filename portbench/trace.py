"""A traced window: `torch.profiler` over the harness's own spans, reduced
to what the per-layer readers need.

`Profiled` wraps a window of work in a profiler and a `portbench.window`
range, with `span(name)` ranges inside it around the calls into each
layer.  After the window it exports the trace (Chrome format, into the
run's temporary directory, deleted at once) and keeps:

- every device operation (kernels, copies, fills) with its interval on
  the device's clock and the host time of the call that launched it
  (by the trace's correlation ids);
- the harness's spans by name, on the host's clock;
- the host's operators, to name what the host did while the device idled.

Times are microseconds on the profiler's one clock.
"""
from __future__ import annotations

import heapq
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def merged(intervals) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class Trace:
    """The reduced trace of one window."""

    def __init__(self, events: list):
        launch_ts = {}
        self.device, self.spans, self.host = [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, corr))
            elif cat == "user_annotation":
                self.spans.setdefault(e["name"], []).append((ts, ts + dur))
            if cat in LAUNCH_CATS and corr is not None:
                launch_ts[corr] = ts
            if cat in HOST_CATS and not e["name"].startswith("portbench."):
                self.host.append((ts, ts + dur, e["name"]))
        self.launched_at = [launch_ts.get(c) for _, _, _, c in self.device]
        (lo, hi), = self.spans[WINDOW]
        self.window = (lo, hi)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        """Device time inside the window: the union of every device
        operation's interval, clipped to the window."""
        lo, hi = self.window
        return union_us((max(a, lo), min(b, hi)) for _, a, b, _ in
                        self.device if b > lo and a < hi)

    def launched_in(self, span: str) -> list:
        """The device operations whose launch lies inside a span of that
        name, as (name, start, end)."""
        spans = sorted(self.spans.get(span, []))
        out = []
        for (name, a, b, _), at in zip(self.device, self.launched_at):
            if at is None:
                continue
            if any(lo <= at <= hi for lo, hi in spans):
                out.append((name, a, b))
        return out

    def top_device_ops(self, n: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took the most
        time, summed by name."""
        by = {}
        for name, a, b, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t / 1e6] for name, t in top]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host operator, seconds], ...]: the device's idle time inside
        the window, each gap named by the innermost host operator running
        at its middle, summed by name, the longest first."""
        lo, hi = self.window
        busy = merged((max(a, lo), min(b, hi)) for _, a, b, _ in
                      self.device if b > lo and a < hi)
        gaps, at = [], lo
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if hi > at:
            gaps.append((at, hi))
        host = sorted(self.host)
        by, active, k = {}, [], 0
        for a, b in gaps:          # in time order: sweep the host's ops
            mid = 0.5 * (a + b)
            while k < len(host) and host[k][0] <= mid:
                heapq.heappush(active, (host[k][1], host[k][0], host[k][2]))
                k += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            inner = min(active, key=lambda h: h[0] - h[1], default=None)
            name = inner[2] if inner else "(no host operator)"
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], t / 1e6] for name, t in top]


class Profiled:
    """with Profiled() as p: ... p.span(name) ...; then p.trace."""

    def __init__(self):
        self.trace = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._cuda = torch.cuda.is_available()
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self._cuda else []))
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()
        return self

    def span(self, name: str):
        return self._torch.profiler.record_function("portbench." + name)

    def __exit__(self, *exc):
        if self._cuda:
            self._torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = Trace(events)
        return False

