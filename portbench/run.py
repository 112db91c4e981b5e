"""Run one cell of the benchmark of `gym_pybullet_drones_tpu_torch` once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix, its limits and its per-layer readers are found by name
(`portbench/cell.py`).  The run refuses to start without as many CUDA
cards as the cell asks for, builds everything from the seed, warms up,
measures a window of `--seconds`, then checks what the window produced
against the plain reference (`portbench/reference/`) and prints, as its
last lines on standard error, each number compared beside its limit, and
as the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics with `--trace
0`, the per-layer ones with `--trace 1`), `device`, with `--trace 1`
also `breakdown`, `host` (what the host did in the window,
`portbench/hostclock.py`), and last `checked`, the numbers and their
limits.

It exits with another code than 0, and prints no result, if the process
holds JAX or the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gym_pybullet_drones_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names of `modules` (default `sys.modules`) that are JAX
    or the JAX package, each compared whole: the port
    `gym_pybullet_drones_tpu_torch` begins with the JAX package's name
    and is not one of them."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_record(cell, peak: int, trace_info=None) -> dict:
    import torch
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace_info is not None:
        rec["busy_s"] = trace_info["busy_s"]
        rec["window_s"] = trace_info["window_s"]
    return rec


def measure(cell, seed: int, seconds: float, traced: bool, device,
            t_start: float) -> dict:
    """Run the cell's driver and read its metrics: the driver's result
    with `metrics` (the end-to-end ones, or the per-layer ones of a traced
    run), `checked` and `correct` added."""
    from portbench import check
    from portbench.cell import driver, reader

    out = driver(cell.traffic["driver"]).run(cell, seed, seconds, traced,
                                             device, t_start)
    trace = out["ctx"].get("trace")
    if traced and trace is not None:
        out["trace_info"] = {
            "busy_s": trace.busy_us() / 1e6,
            "window_s": trace.window_us / 1e6,
            "breakdown": {"device_ops": trace.top_device_ops(10),
                          "idle_gaps": trace.idle_gaps(10)}}
    correct, rows = check.judge(out["numbers"], cell.limits)
    out["correct"], out["checked"] = correct, rows
    if not correct:
        out["failed"] = max(out["failed"], sum(
            1 for _, v, lim in rows if not (lim is not None and v <= lim)))
    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        out["metrics"] = {m["name"]: {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    return out


def _number(value):
    """A number as JSON takes it: a value that is not finite as text."""
    return value if math.isfinite(value) else str(value)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import cell as cells
    cell = cells.load(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                  T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window",
              file=sys.stderr)
        return 3
    trace_info = out.get("trace_info")
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": out["metrics"],
              "device": device_record(cell, out["memory_peak_bytes"],
                                      trace_info)}
    if args.trace and trace_info is not None:
        result["breakdown"] = trace_info["breakdown"]
    result["host"] = out["ctx"].get("host")
    result["checked"] = {name: {"value": _number(value), "limit": limit}
                         for name, value, limit in out["checked"]}
    for name, value, limit in out["checked"]:
        print(f"portbench check {name} {value!r} limit {limit!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
