"""The port's spans (`gym_pybullet_drones_tpu_torch/utils/profiling.py`)
on the CPU: the shared no-op when tracing is off, a record's tree and
aggregates, the spans one PPO update makes, outputs bit for bit with
tracing on and off, and the spans as `user_annotation` ranges in a
`torch.profiler` trace.  The update is Hover on DYN physics through the
fused path's plain version, 16 envs x 8 steps, 2 minibatches x 2
epochs; the batched step's spans (`env.batched_step` and the kernel
wrappers' `kernel.dyn_ctrl_step` and `kernel.render`) come from one RGB
step of Hover on DYN with ONE_D_RPM actions, 3 envs, and its `graphed`
attribute from four (on a card the graphed step's capture and three
replays; that case skips elsewhere)."""
import json

import pytest
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask, fast
from gym_pybullet_drones_tpu_torch.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu_torch.utils import profiling
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)

PHASES = ("ppo.update", "ppo.rollout", "ppo.gae", "ppo.optimize")
T = 8


@pytest.fixture(scope="module")
def trainer():
    cfg = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
    task = HoverTask(act=ActionType.RPM)
    ppo = PPOConfig(num_envs=16, rollout_steps=T, num_minibatches=2,
                    update_epochs=2)
    init, update, _, _ = make_train(cfg, task, ppo, device="cpu")
    assert update.env_path == "fused"
    return init, update


def one_update(trainer):
    init, update = trainer
    return update(init(torch.Generator().manual_seed(7)))


class FakeClock:
    """perf_counter_ns in whole steps that the test sets."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


def test_off_is_the_shared_no_op(trainer):
    assert profiling.span("a") is profiling.span("b", bytes=4)
    assert profiling.span("a") is profiling.OFF
    with pytest.raises(KeyError):
        with profiling.span("a"):
            raise KeyError("through")
    one_update(trainer)
    # the update opened no record, and a record opened after it is empty
    assert profiling._record is None
    with profiling.recording() as rec:
        pass
    assert rec.summary() == {} and len(rec.spans) == 0


def test_record_tree_self_time_attrs_and_ring(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profiling, "_clock", clock)
    monkeypatch.setattr(profiling, "RING_CAPACITY", 4)
    with profiling.recording() as rec:
        with profiling.span("outer", bytes=10):        # 0 .. 10
            clock.now = 1
            with profiling.span("inner", bytes=3):     # 1 .. 4
                clock.now = 4
            with profiling.span("inner", bytes=5, n=2):  # 4 .. 6
                clock.now = 6
            clock.now = 10
        for k in range(3):                           # 10 .. 12, 14, 16
            with profiling.span("tail"):
                clock.now += 2
    got = rec.summary()
    assert got["outer"] == {"count": 1, "total_s": 10e-9, "self_s": 5e-9,
                            "attrs": {"bytes": 10}}
    assert got["inner"] == {"count": 2, "total_s": 5e-9, "self_s": 5e-9,
                            "attrs": {"bytes": 8, "n": 2}}
    assert got["tail"]["count"] == 3 and got["tail"]["total_s"] == 6e-9
    # the ring keeps the latest 4 of 6 spans; the aggregates all 6
    assert [s[:4] for s in rec.spans] == [
        ("outer", None, 0, 10), ("tail", None, 10, 12),
        ("tail", None, 12, 14), ("tail", None, 14, 16)]
    assert rec.spans[0][4] == {"bytes": 10}
    assert sum(v["count"] for v in got.values()) == 6
    assert profiling._record is None


def test_update_span_tree(trainer):
    with profiling.recording() as rec:
        one_update(trainer)
    got = rec.summary()
    counts = {name: got[name]["count"] for name in got}
    assert counts == {**{p: 1 for p in PHASES}, "env.fused_step": T,
                      "kernel.fused_env_step": T}
    parents = {(name, parent) for name, parent, *_ in rec.spans}
    assert parents == {
        ("ppo.update", None), ("ppo.rollout", "ppo.update"),
        ("ppo.gae", "ppo.update"), ("ppo.optimize", "ppo.update"),
        ("env.fused_step", "ppo.rollout"),
        ("kernel.fused_env_step", "env.fused_step")}
    update = got["ppo.update"]
    phases = sum(got[p]["total_s"] for p in PHASES[1:])
    assert 0 < phases <= update["total_s"]
    assert update["self_s"] == pytest.approx(update["total_s"] - phases,
                                             abs=1e-9)


def test_tracing_leaves_outputs_bit_for_bit(trainer, tmp_path):
    ts_off, m_off = one_update(trainer)
    with profiling.trace(str(tmp_path)), profiling.recording():
        ts_on, m_on = one_update(trainer)
    for a, b in zip(ts_off.network.parameters(), ts_on.network.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(ts_off.opt_state.mu + ts_off.opt_state.nu,
                    ts_on.opt_state.mu + ts_on.opt_state.nu):
        assert torch.equal(a, b)
    assert torch.equal(ts_off.env_state, ts_on.env_state)
    assert torch.equal(ts_off.last_obs, ts_on.last_obs)
    assert m_off.keys() == m_on.keys()
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    # the spans are user_annotation ranges of the profiler's trace
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in PHASES:
        assert names.count(name) == 1, name
    assert names.count("env.fused_step") == T
    assert names.count("kernel.fused_env_step") == T


BATCHED = ("env.batched_step", "kernel.dyn_ctrl_step", "kernel.render")


def rgb_step():
    """A call of one RGB batched step from the reset, 3 envs."""
    cfg = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
    task = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB)
    reset_fn, step_fn = fast.make_batched_step(cfg, task, 3,
                                               obs_layout="flat",
                                               device="cpu")
    state, _ = reset_fn()
    action = torch.full((3, 1, 1), 0.5)
    return lambda: step_fn(state, action)


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in leaves(t)]


def test_batched_step_spans_and_attributes():
    step = rgb_step()
    with profiling.recording() as rec:
        step()
    got = rec.summary()
    assert {name: got[name]["count"] for name in got} == {
        name: 1 for name in BATCHED}
    assert got["kernel.render"]["attrs"] == {"cameras": 3}
    assert got["kernel.dyn_ctrl_step"]["attrs"] == {"columns": 3}
    assert got["env.batched_step"]["attrs"] == {"graphed": 0}
    parents = {(name, parent) for name, parent, *_ in rec.spans}
    assert parents == {("env.batched_step", None),
                       ("kernel.dyn_ctrl_step", "env.batched_step"),
                       ("kernel.render", "env.batched_step")}


def test_batched_step_spans_off_make_nothing(monkeypatch):
    """With tracing off the step's spans are the shared no-op: no span
    object is made; recording on makes the three."""
    step = rgb_step()
    made = []
    real = profiling._Span

    def spy(name, attrs, record):
        made.append(name)
        return real(name, attrs, record)
    monkeypatch.setattr(profiling, "_Span", spy)
    step()
    assert made == []
    with profiling.recording():
        step()
    assert sorted(made) == sorted(BATCHED)


def test_batched_step_bit_for_bit_with_tracing(tmp_path):
    step = rgb_step()
    off = step()
    with profiling.trace(str(tmp_path)), profiling.recording():
        on = step()
    assert len(leaves(off)) == len(leaves(on))
    for a, b in zip(leaves(off), leaves(on)):
        assert torch.equal(a, b)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(names) == sorted(BATCHED)


def rgb_rollout(device, steps: int):
    """`steps` chained RGB batched steps of 3 envs from the reset: every
    call's results and its span's `graphed` attribute (None where nothing
    was recorded)."""
    cfg = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
    task = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB)
    reset_fn, step_fn = fast.make_batched_step(cfg, task, 3,
                                               obs_layout="flat",
                                               device=device)
    state, _ = reset_fn()
    results = []
    for t in range(steps):
        results.append(step_fn(state, torch.full((3, 1, 1), 0.1 * t,
                                                  device=device)))
        state = results[-1][0]
    return results


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_batched_step_graphed_attribute_bit_for_bit(device):
    """Four chained RGB steps with recording off and on: equal bit for
    bit, and every `env.batched_step` span carries `graphed`: 0 on the
    host; on a card 0 for the first call, which captures, and 1 for the
    three replays."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed batched step exists "
                    "only there")
    off = rgb_rollout(device, 4)
    with profiling.recording() as rec:
        on = rgb_rollout(device, 4)
    for a, b in zip(off, on, strict=True):
        for x, y in zip(leaves(a), leaves(b), strict=True):
            assert torch.equal(x, y)
    graphed = [s[4]["graphed"] for s in rec.spans
               if s[0] == "env.batched_step"]
    assert graphed == ([0, 0, 0, 0] if device == "cpu" else [0, 1, 1, 1])
    assert rec.summary()["env.batched_step"]["attrs"] == {
        "graphed": sum(graphed)}
