"""The metrics that read the program's own records (`portbench/program.py`
and its readers): each reader on a hand-made ctx, the attribution of
device operations to spans against `Trace.launched_in`, traced runs of a
small rollout and a small training cell on the CPU that record the
program's spans, and a program without spans, whose readers find
nothing."""
import json
import random
import time

import pytest

from portbench import cell as cells
from portbench import program, run
from portbench.trace import Trace

T, R = "hover_dyn.train8192", "routing4_pyb.rollout16384"
READERS = {
    # name: (the ctx it reads, the value it should give)
    "rollout_launches_per_step.train": (
        {"program_trace": {"ppo.rollout": {"spans": 5, "ops": 10560,
                                           "device_s": 0.1}},
         "rollout_steps": 64}, 33.0),
    "optimize_launches_per_step.train": (
        {"program_trace": {"ppo.optimize": {"spans": 5, "ops": 16400,
                                            "device_s": 0.1}},
         "optimize_steps": 16}, 205.0),
    "optimize_device_ms.train": (
        {"program_trace": {"ppo.optimize": {"spans": 5, "ops": 16400,
                                            "device_s": 0.1}}}, 20.0),
    "gae_ms.train": (
        {"program_spans": {"ppo.gae": {"count": 4, "total_s": 0.02,
                                       "self_s": 0.02, "attrs": {}}}}, 5.0),
    "step_launches.rollout": (
        {"program_trace": {"env.fused_step": {"spans": 512, "ops": 2048,
                                              "device_s": 0.1}},
         "env_steps_traced": 512}, 4.0),
    "fused_launch_host_ms.rollout": (
        {"program_spans": {"kernel.fused_env_step": {
            "count": 512, "total_s": 0.02048, "self_s": 0.02048,
            "attrs": {}}}}, 0.04),
    "kernel_load_s": ({"kernel_load_s": 1.5}, 1.5),
}


def test_every_new_metric_has_a_case():
    with open("BENCHMARK.json") as f:
        names = {m["name"] for m in json.load(f)["per_layer"]}
    assert set(READERS) <= names


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_hand_made_ctx(name):
    ctx, want = READERS[name]
    read = cells.reader(name)
    assert read({program.DONE: True, **ctx}) == pytest.approx(want)
    assert read({program.DONE: True}) is None


def synthetic_trace(rng, n_ops=400, n_spans=30):
    """Chrome events: device operations launched at random host times,
    some without a launch, and spans of two names that may overlap."""
    events = [{"ph": "X", "cat": "user_annotation",
               "name": "portbench.window", "ts": 0, "dur": 1e6}]
    for corr in range(n_ops):
        at = rng.uniform(0, 1e6)
        if rng.random() < 0.95:
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "ts": at, "dur": 3,
                           "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": f"k{corr % 7}",
                       "ts": at + 5, "dur": rng.uniform(1, 50),
                       "args": {"correlation": corr}})
    for k in range(n_spans):
        lo = rng.uniform(0, 1e6)
        events.append({"ph": "X", "cat": "user_annotation",
                       "name": "ab"[k % 2], "ts": lo,
                       "dur": rng.uniform(0, 1e5)})
    return Trace(events)


@pytest.mark.parametrize("seed", range(5))
def test_attribution_matches_launched_in(seed):
    trace = synthetic_trace(random.Random(seed))
    got = program.attribute(trace)
    assert set(got) == {"a", "b"}
    for name in ("a", "b"):
        want = trace.launched_in(name)
        assert got[name]["spans"] == len(trace.spans[name])
        assert got[name]["ops"] == len(want)
        assert got[name]["device_s"] == pytest.approx(
            sum(b - a for _, a, b in want) / 1e6, rel=1e-9, abs=1e-12)


def small(workload, **traffic):
    cell = cells.load(workload)
    cell.traffic.update(traffic)
    return cell


def small_rollout():
    """The DYN hover under the `rollout4096` mix at a small size (as in
    test_portbench_faults.py), with the rollout cell's metrics."""
    def read(path):
        with open(path) as f:
            return json.load(f)
    base = cells.load(R)
    mix = read("portbench/traffic/rollout4096.json")
    mix.update(num_envs=16, chunk=8, free_steps=8, sampled_steps=3,
               sampled_chunks=2, trace_chunks=2)
    return cells.Cell("hover_dyn.rollout4096", 1,
                      read("portbench/configs/hover_dyn.json"), mix,
                      read("portbench/limits/hover_dyn.rollout4096.json"),
                      base.end_to_end, base.per_layer)


def traced(monkeypatch, cell, seed=2 ** 31 + 17):
    """A traced run on the CPU whose readers run the program's windows
    for `cell`, as they do for the cell of a run's command line."""
    monkeypatch.setattr(program, "run_of_argv",
                        lambda: (cell, seed, "cpu"))
    return run.measure(cell, seed, 0.05, True, "cpu", time.perf_counter())


def test_traced_rollout_records_the_program_spans(monkeypatch):
    cell = small_rollout()
    out = traced(monkeypatch, cell)
    assert out["correct"]
    ctx = out["ctx"]
    steps = ctx["env_steps_traced"]
    # the rollout's own profiled window holds the program's spans
    for name in ("env.fused_step", "kernel.fused_env_step"):
        assert len(ctx["trace"].spans[name]) == steps
    spans = ctx["program_spans"]
    assert spans["env.fused_step"]["count"] == steps
    assert spans["kernel.fused_env_step"]["count"] == steps
    assert out["metrics"]["fused_launch_host_ms.rollout"]["value"] > 0
    # the CPU runs no device operation: nothing to count launches of
    assert "program_trace" not in ctx
    assert "step_launches.rollout" not in out["metrics"]


def test_traced_training_records_the_program_spans(monkeypatch):
    cell = small(T, num_envs=32, rollout_steps=8, trace_updates=2)
    out = traced(monkeypatch, cell)
    assert out["correct"]
    ctx = out["ctx"]
    assert ctx["rollout_steps"] == 8 and ctx["optimize_steps"] == 16
    spans = ctx["program_spans"]
    for name in ("ppo.update", "ppo.rollout", "ppo.gae", "ppo.optimize"):
        assert spans[name]["count"] == 2
    assert spans["env.fused_step"]["count"] == 16
    assert out["metrics"]["gae_ms.train"]["value"] > 0
    for name in ("rollout_launches_per_step.train",
                 "optimize_launches_per_step.train",
                 "optimize_device_ms.train"):
        assert name not in out["metrics"]


def test_a_program_without_spans_reports_nothing(monkeypatch):
    """A program from before the spans: its profiling module has no
    `recording` and `_build` no `load_seconds`; every new reader finds
    nothing."""
    from gym_pybullet_drones_tpu_torch import _build
    from gym_pybullet_drones_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "recording")
    monkeypatch.delattr(_build, "load_seconds")
    monkeypatch.setattr(program, "run_of_argv", lambda: pytest.fail(
        "no window runs for a program without spans"))
    trace = synthetic_trace(random.Random(0))
    for name in READERS:
        assert cells.reader(name)({"trace": trace,
                                   "env_steps_traced": 8}) is None
