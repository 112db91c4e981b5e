"""A cell of the benchmark, found by its name in `BENCHMARK.json`.

Everything that belongs to one configuration, one traffic mix, one cell's
limits or one per-layer metric lives in a file of its own, found by the
name that `BENCHMARK.json` gives it:

- `configs/<config>.json` (the `file` of the configuration's entry);
- `traffic/<traffic>.json`, whose `driver` names the general driver that
  runs it (`drivers/<driver>.py`) and whose other keys are its
  parameters;
- `limits/<workload>.json`, each number that decides `correct` with its
  limit and the readings the limit was set from;
- `metrics/<metric>.py` for each per-layer metric, a reader with
  `read(ctx) -> float | None`.

A later change adds a cell, a configuration, a mix or a metric as new
files and new entries; no file here names any of them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: str = ROOT


def _reports(metric: dict, workload: str, end_to_end_names) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load(workload: str, bench_path: str = "BENCHMARK.json",
         root: str = ROOT) -> Cell:
    """The cell `workload` of the benchmark file at `bench_path`, its
    traffic, limits and readers under `root`."""
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(conf["file"]) as f:
        config = json.load(f)
    with open(os.path.join(root, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(root, "limits", workload + ".json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, e2e_names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, root)


def reader(metric_name: str, root: str = ROOT):
    """The `read` function of `<root>/metrics/<metric_name>.py`."""
    path = os.path.join(root, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    """The module `drivers/<name>.py`."""
    return importlib.import_module(f"portbench.drivers.{name}")
