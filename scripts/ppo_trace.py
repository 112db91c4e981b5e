#!/usr/bin/env python3
"""Where one PPO update's time goes on the card: host against device.

    python3 scripts/ppo_trace.py [--updates 3]

Needs one CUDA card and nvcc.  Builds the port's trainer (`rl/ppo.py`) in
the two configurations `chip_smoke.py` drives — `ppo_hover8192` (Hover,
DYN, RPM, 8192 envs x 64 steps, 4 minibatches, 4 epochs) and
`ppo_hover_pyb_learn` (Hover, PYB, ONE_D_RPM, 64 envs x 64 steps, 4
minibatches, 10 epochs) — runs one warm-up update, then traces
`--updates` updates twice, the rollout and the optimizer steps apart (a
synchronize between them, as in `chip_smoke.py`): first on the host's
clock alone, then under `torch.profiler` with each phase in a range of
its own.  The profiler's own host overhead stretches the second run's
wall time, so each phase's device busy share is the device time of its
kernels (the union of their intervals, from the trace) over its wall time
on the host's clock (from the first run).  Prints one JSON line per
configuration: per phase, that wall time, the kernels' device time,
launches and busy share; the kernels with the most device time; then the
card's name and power limit.  Exits 1 if the trace holds no device time.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gym_pybullet_drones_tpu_torch import params as P  # noqa: E402
from gym_pybullet_drones_tpu_torch.envs import (  # noqa: E402
    AviaryConfig, HoverTask)
from gym_pybullet_drones_tpu_torch.rl import PPOConfig, make_train  # noqa: E402
from gym_pybullet_drones_tpu_torch.utils.enums import (  # noqa: E402
    ActionType, Physics)

CONFIGS = {
    "ppo_hover8192": (Physics.DYN, ActionType.RPM,
                      PPOConfig(num_envs=8192, rollout_steps=64,
                                num_minibatches=4, update_epochs=4)),
    "ppo_hover_pyb_learn": (Physics.PYB, ActionType.ONE_D_RPM,
                            PPOConfig(num_envs=64, rollout_steps=64,
                                      num_minibatches=4, update_epochs=10)),
}


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace(name, physics, act, ppo, updates):
    cfg = AviaryConfig(P.CF2X, 1, physics, 240, 30)
    init, update, _, _ = make_train(cfg, HoverTask(act=act), ppo)
    ts = init(torch.Generator("cuda").manual_seed(0))
    ts, metrics = update(ts)
    float(metrics["mean_reward"])
    labels = ("ppo.rollout", "ppo.optimize")

    # the host's clock alone: wall time per phase
    wall = dict.fromkeys(labels, 0.0)
    stamps = []

    def mark():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    for _ in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, metrics = update(ts, after_rollout=mark)
        float(metrics["mean_reward"])
        t2 = time.perf_counter()
        wall["ppo.rollout"] += stamps[-1] - t0
        wall["ppo.optimize"] += t2 - stamps[-1]

    # the trace: each phase in a range of its own
    ranges = []

    def switch():
        # the rollout's kernels run inside its range, the optimizer's in
        # theirs: a kernel is counted where it starts
        torch.cuda.synchronize()
        ranges.pop().__exit__(None, None, None)
        ranges.append(record_function(labels[1]))
        ranges[-1].__enter__()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(updates):
            ranges.append(record_function(labels[0]))
            ranges[-1].__enter__()
            ts, metrics = update(ts, after_rollout=switch)
            float(metrics["mean_reward"])
            ranges.pop().__exit__(None, None, None)
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device events, without the ranges' own projection onto the device
    kernels = [e for e in events
               if e.device_type == cuda and e.name not in labels]
    if not kernels:
        raise SystemExit(f"{name}: the trace holds no device time")
    phases = {}
    for label in labels:
        spans = [e.time_range for e in events
                 if e.name == label and e.device_type != cuda]
        inside = [k for k in kernels if any(
            s.start <= k.time_range.start <= s.end for s in spans)]
        busy = busy_us([(k.time_range.start, k.time_range.end)
                        for k in inside]) / 1e3
        phases[label] = {
            "wall_ms_per_update": wall[label] * 1e3 / updates,
            "device_ms_per_update": busy / updates,
            "busy_share": busy / (wall[label] * 1e3),
            "launches_per_update": len(inside) / updates,
            "traced_wall_ms_per_update":
                sum(s.end - s.start for s in spans) / 1e3 / updates,
        }
    by_name = {}
    for k in kernels:
        n, t = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, t + k.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"config": name, "updates": updates, "phases": phases,
            "top_kernels": [{"name": n[:80], "launches": c / updates,
                             "ms_per_update": t / updates / 1e3}
                            for n, (c, t) in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--updates", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ppo_trace: needs one CUDA card", file=sys.stderr)
        return 1
    for name, (physics, act, ppo) in CONFIGS.items():
        print(json.dumps(trace(name, physics, act, ppo, args.updates)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
