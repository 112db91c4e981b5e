"""BENCHMARK.json against the rules of its format, every cell loadable by
name, and a new cell, configuration, mix and metric added as new files
only."""
import json
import os
import re
import shutil

import pytest

from portbench import cell as cells
from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open("BENCHMARK.json") as f:
        return json.load(f)


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_format():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert all(PATH.match(p) and ".." not in p.split("/")
               and not p.startswith("/") for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(line_ok(w)
                                                for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and os.path.isfile(c["file"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    names = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        names.add(w["name"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= names
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_ok(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert os.path.isfile(f"portbench/metrics/{m['name']}.py")


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_loads_by_name(workload):
    cell = cells.load(workload)
    assert cell.traffic["driver"] in ("rollout", "train")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in names
    assert all(v.get("limit") is not None for v in cell.limits.values())


def test_new_cell_added_by_files_only(tmp_path):
    """A dummy configuration, mix, cell and metric, written as new files
    beside copies of the existing ones, run through the harness."""
    root = tmp_path / "portbench"
    for sub in ("traffic", "limits", "metrics", "configs"):
        shutil.copytree(f"portbench/{sub}", root / sub)
    b = bench()
    cfg = json.load(open("portbench/configs/hover_dyn.json"))
    cfg["env"]["task"]["target_pos"] = [0.5, 0.0, 1.0]
    (root / "configs" / "hover_far.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny.json").write_text(json.dumps({
        "driver": "rollout", "num_envs": 8, "chunk": 4, "action_scale": 0.1,
        "free_steps": 4, "sampled_steps": 2, "sampled_chunks": 2,
        "trace_chunks": 1}))
    limits = json.load(open("portbench/limits/hover_dyn.rollout4096.json"))
    (root / "limits" / "hover_far.tiny.json").write_text(json.dumps(limits))
    (root / "metrics" / "steps_done.rollout.py").write_text(
        "def read(ctx):\n    return float(ctx['env_steps_window'])\n")
    b["configs"].append({"name": "hover_far", "source": "test",
                         "file": str(root / "configs" / "hover_far.json"),
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "hover_far.tiny", "config": "hover_far",
                           "traffic": "tiny", "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("hover_far.tiny")
    b["per_layer"].append({"name": "steps_done.rollout", "unit": "1",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "env_steps_per_s",
                           "workloads": ["hover_far.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = cells.load("hover_far.tiny", str(tmp_path / "BENCHMARK.json"),
                      str(root))
    out = run.measure(cell, 5, 0.05, True, "cpu", 0.0)
    assert out["correct"]
    assert out["metrics"]["steps_done.rollout"]["value"] > 0
