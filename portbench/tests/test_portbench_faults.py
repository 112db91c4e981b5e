"""The comparison that decides `correct`, shown to fail.

Each test drives a run past the harness's look for a card (on the CPU,
where the port runs its kernels' plain versions, at a small size) with
the timed path broken underneath, and sees `correct` come out false; and
the controls of the calibration (`portbench.calibrate`) fail the limits
too.  A sound run at the same size comes out true.
"""
import json
import time

import pytest
import torch

from portbench import calibrate, cell as cells, check, run
from portbench.drivers import train as train_driver

ROLLOUT = {"num_envs": 16, "chunk": 8, "free_steps": 8, "sampled_steps": 3,
           "sampled_chunks": 2, "trace_chunks": 1}
TRAIN = {"num_envs": 32, "rollout_steps": 8, "trace_updates": 1}


def tiny(workload, **traffic):
    cell = cells.load(workload)
    cell.traffic.update(traffic)
    return cell


def hover_rollout(**traffic):
    """The DYN hover under the `rollout4096` mix, built from its files at
    a small size: the rollout driver's fastest case on the CPU.
    BENCHMARK.json holds no DYN rollout cell (its host-bound runs spread
    too widely for a bound); its mix and limits stay for these tests and
    for a later cell."""
    def read(path):
        with open(path) as f:
            return json.load(f)
    base = cells.load("routing4_pyb.rollout16384")
    mix = read("portbench/traffic/rollout4096.json")
    mix.update(traffic)
    return cells.Cell("hover_dyn.rollout4096", 1,
                      read("portbench/configs/hover_dyn.json"), mix,
                      read("portbench/limits/hover_dyn.rollout4096.json"),
                      base.end_to_end, base.per_layer)


def measure(cell, seed=2 ** 31 + 11):
    return run.measure(cell, seed, 0.05, False, "cpu", time.perf_counter())


def test_sound_runs_are_correct():
    assert measure(hover_rollout(**ROLLOUT))["correct"]
    assert measure(tiny("hover_dyn.train8192", **TRAIN))["correct"]


def broken_rollout(monkeypatch, fault):
    from gym_pybullet_drones_tpu_torch.envs import fast
    real = fast.make_fused_rollout

    def make(*args, **kwargs):
        reset_fn, step_fn = real(*args, **kwargs)

        def step(carry, action):
            new, obs, rew, term, trunc = step_fn(carry, action)
            if fault == "unchanged":
                return carry, obs, rew, term, trunc
            obs = obs.clone()
            obs[0, 0] += 0.1 * (1.0 + obs[0, 0].abs())
            return new, obs, rew, term, trunc
        return reset_fn, step
    monkeypatch.setattr(fast, "make_fused_rollout", make)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_broken_rollout_is_not_correct(monkeypatch, fault):
    broken_rollout(monkeypatch, fault)
    out = measure(hover_rollout(**ROLLOUT))
    assert not out["correct"], out["numbers"]


def test_state_left_unchanged_is_not_correct(monkeypatch):
    from gym_pybullet_drones_tpu_torch.rl import ppo
    real = ppo.make_train

    def make(*args, **kwargs):
        init, update, evaluate, net = real(*args, **kwargs)

        def frozen(ts, draws=None, after_rollout=None):
            keep = [p.detach().clone() for p in ts.network.parameters()]
            new, metrics = update(ts, draws, after_rollout)
            with torch.no_grad():
                for p, k in zip(ts.network.parameters(), keep):
                    p.copy_(k)
            return ts, metrics
        return init, frozen, evaluate, net
    monkeypatch.setattr(ppo, "make_train", make)
    out = measure(tiny("hover_dyn.train8192", **TRAIN))
    assert not out["correct"]
    assert out["numbers"]["change_gap"] == pytest.approx(1.0)


def test_half_batch_left_out_is_not_correct(monkeypatch):
    from gym_pybullet_drones_tpu_torch.rl import ppo
    real = ppo.ppo_loss

    def half(net, batch, advantages, returns, cfg, mesh=None):
        m = advantages.shape[1] // 2
        cut = type(batch)(*(x[:, :m] for x in batch))
        return real(net, cut, advantages[:, :m], returns[:, :m], cfg, mesh)
    monkeypatch.setattr(ppo, "ppo_loss", half)
    out = measure(tiny("hover_dyn.train8192", **TRAIN))
    assert not out["correct"], out["numbers"]


def rank_without_exchange(mesh, *args):
    """A rank whose collectives sum nothing: each rank trains on its own
    envs alone."""
    type(mesh).all_reduce = lambda self, x: x
    return train_driver.train_loop(mesh, *args[:4], None, args[4])


def test_exchange_left_out_is_not_correct(monkeypatch):
    monkeypatch.setattr(train_driver, "rank_main", rank_without_exchange)
    cell = tiny("hover_dyn.train8192", ranks=2, **TRAIN)
    out = measure(cell)
    assert not out["correct"], out["numbers"]


def test_sharded_run_is_correct():
    cell = tiny("hover_dyn.train8192", ranks=2, **TRAIN)
    assert measure(cell)["correct"]


def test_rollout_controls_fail():
    cell = hover_rollout(**ROLLOUT)
    readings = []
    calibrate.rollout_readings(cell, [], [3], "cpu", readings.append)
    assert {r["kind"] for r in readings} == {"bfloat16", "unchanged",
                                            "altered"}
    for r in readings:
        numbers = {k: r[k] for k in cell.limits}
        assert not check.judge(numbers, cell.limits)[0], r


def test_lower_precision_inside_update_is_not_correct(monkeypatch):
    """The update computes in bfloat16 (autocast around the call), as a
    TF32 or autocast path inside the timed call would: `policy_gap`,
    read from the update's own forward passes, fails."""
    from gym_pybullet_drones_tpu_torch.rl import ppo
    real = ppo.make_train

    def make(*args, **kwargs):
        init, update, evaluate, net = real(*args, **kwargs)

        def lower(ts, draws=None, after_rollout=None):
            with torch.autocast("cpu", dtype=torch.bfloat16):
                return update(ts, draws, after_rollout)
        return init, lower, evaluate, net
    monkeypatch.setattr(ppo, "make_train", make)
    cell = tiny("hover_dyn.train8192", **TRAIN)
    out = measure(cell)
    assert not out["correct"]
    assert out["numbers"]["policy_gap"] > cell.limits["policy_gap"]["limit"]


def test_train_controls_fail():
    cell = tiny("hover_dyn.train8192", **TRAIN)
    readings = []
    calibrate.train_readings(cell, [], [3], "cpu", readings.append)
    assert {r["kind"] for r in readings} == {"bfloat16", "tf32",
                                            "half_batch"}
    for r in readings:
        if r["kind"] == "tf32":
            continue    # no TF32 on the CPU: `test_portbench_card.py`
        numbers = {k: r[k] for k in cell.limits if k in r}
        assert not check.judge(numbers, cell.limits)[0], r
