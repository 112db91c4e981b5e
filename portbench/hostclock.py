"""What the host did during a measured window, printed beside a run's
result (under `host`, not a metric): the process's CPU seconds, its
involuntary context switches, the machine's stolen CPU seconds, the
garbage collector's seconds, and the window's rate in each quarter of its
time.  They tell a run that the host slowed from one that did more work:
the host-bound cells spread between runs by the host's speed.
"""
from __future__ import annotations

import gc
import os
import resource
import time


def _steal_s():
    """The machine's stolen CPU seconds so far (all CPUs, `/proc/stat`),
    or None where there is no such file."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return None


def quarters(t0: float, t1: float, marks: list) -> list:
    """The rate of work in each quarter of [t0, t1]: `marks` are
    (time, work done so far), work counted when it completes."""
    out, done = [], 0.0
    span = (t1 - t0) / 4
    for q in range(1, 5):
        end = t0 + q * span
        upto = max((w for t, w in marks if t <= end), default=0.0)
        out.append((upto - done) / span if span > 0 else 0.0)
        done = upto
    return out


class Usage:
    """Counts from its creation to `stop()`; `mark(work)` after each piece
    of work with the work done so far."""

    def __init__(self):
        self.gc_s, self._gc_t0, self.marks = 0.0, None, []
        gc.callbacks.append(self._gc)
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)
        self.steal0 = _steal_s()
        self.t0 = time.perf_counter()

    def _gc(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def mark(self, work: float):
        self.marks.append((time.perf_counter(), float(work)))

    def stop(self) -> dict:
        t1 = time.perf_counter()
        gc.callbacks.remove(self._gc)
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        steal1 = _steal_s()
        return {
            "wall_s": t1 - self.t0,
            "cpu_s": (r1.ru_utime - self.r0.ru_utime)
            + (r1.ru_stime - self.r0.ru_stime),
            "involuntary_switches": r1.ru_nivcsw - self.r0.ru_nivcsw,
            "steal_s": None if steal1 is None or self.steal0 is None
            else steal1 - self.steal0,
            "gc_s": self.gc_s,
            "quarter_rates": quarters(self.t0, t1, self.marks)}
