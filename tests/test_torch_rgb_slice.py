"""The RGB-observation slice of the port against the JAX package, on the
CPU: each drone's camera image as its observation (`envs/tasks.py`, the
render kernel's plain version `ops/render.py`), through `core.reset` /
`core.step`, through `make_batched_step` with its auto-reset (Hover with
RPM and ONE_D_RPM actions, MultiHover's drones seeing each other), one PPO
update of the NatureCNN policy (`rl/ppo.py`, `models/cnn.py`) from the
same weights and draws, and `train_to_threshold.py --rgb`.

Images are held by `assert_obs_close` (tests/_torch_helpers.py): rgba
within 1 of 255, but a pixel at a tie (a grazed silhouette, a tile line)
may take the other value, on at most 0.1% of the pixels.  Rewards, flags
and state at tests/test_fused.py's 2e-5 / 1e-4.  The JAX side runs its
batched step with use_pallas=False, whose RGB post-processing is the
vmapped per-env methods (its envs/fast.py:218-242).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import core as jcore, fast as jfast
from gym_pybullet_drones_tpu.rl import ppo as jppo

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import core as tcore, fast as tfast
from gym_pybullet_drones_tpu_torch.examples import train_to_threshold
from gym_pybullet_drones_tpu_torch.models import ActorCriticCNN
from gym_pybullet_drones_tpu_torch.ops import kernel_render, render
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

from tests._torch_helpers import ATOL, RTOL, assert_obs_close, pair

IMG = 48 * 64 * 4
# 0.125 s episodes: every env truncates on control step 5 (its counter, 32
# substeps, is the first above 30)
EPISODE_S = 0.125
# One PPO update: 4 envs x 4 steps, 2 minibatches of 2 steps, 1 epoch (2
# Adam steps of lr 3e-4).  The rollouts' images agree pixel for pixel away
# from ties; the CNN's float32 sums differ in order.  Measured: 3e-8 on
# the weights (which move by 6e-4), 9e-7 relative on mean_value, 7.5e-8
# absolute on pg_loss (0.0056).
PARAM_ATOL = 1e-6
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
E, T, MB, EPOCHS = 4, 4, 2, 1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, and the suite runs files side by side: one intra-op
    thread runs them faster than a pool that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rgb(task, **kw):
    return dataclasses.replace(task, obs=type(task.obs).RGB, **kw)


def _rgb_pair(kind="hover", act="rpm", **kw):
    (jcfg, jtask), (tcfg, ttask) = pair(kind, act)
    return (jcfg, _rgb(jtask, **kw)), (tcfg, _rgb(ttask, **kw))


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_reset_and_step_obs_match_jax():
    (jcfg, jtask), (tcfg, ttask) = _rgb_pair()
    assert ttask.obs_dim(tcfg) == IMG
    js, jobs, _ = jcore.reset(jcfg, jtask)
    ts, tobs, _ = tcore.reset(tcfg, ttask, device="cpu")
    assert tobs.shape == (1, 48, 64, 4) == jobs.shape
    assert_obs_close(tobs, jobs)
    a = np.asarray([[0.3, -0.2, 0.1, 0.0]], np.float32)
    for _ in range(3):
        js, jobs, jr, jte, jtr, _ = jcore.step(jcfg, jtask, js,
                                               jnp.asarray(a))
        ts, tobs, tr, tte, ttr, _ = tcore.step(tcfg, ttask, ts,
                                               torch.from_numpy(a))
        assert_obs_close(tobs, jobs)
        _close(tr, jr, "reward")
        assert bool(tte) == bool(jte) and bool(ttr) == bool(jtr)
    _close(ts.pos, js.pos, "pos")


@pytest.mark.parametrize("kind,act", [("hover", "rpm"),
                                      ("hover", "one_d_rpm"),
                                      ("multihover", "rpm")])
def test_batched_step_matches_jax(kind, act):
    """8 envs x 6 steps of 0.1 N(0, 1) actions: every env truncates on
    step 5 and auto-resets to the initial image."""
    b, steps = 8, 6
    (jcfg, jtask), (tcfg, ttask) = _rgb_pair(kind, act,
                                             episode_len_sec=EPISODE_S)
    n, adim = tcfg.num_drones, ttask.action_dim(tcfg)
    j_reset, j_step = jfast.make_batched_step(
        jcfg, jtask, b, use_pallas=False, obs_layout="flat")
    j_step = jax.jit(j_step)
    t_reset, t_step = tfast.make_batched_step(tcfg, ttask, b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    ts, tobs = t_reset()
    assert tobs.shape == (b, n * IMG)
    assert_obs_close(tobs, jobs)
    if n > 1:
        # at the spawn, drone 0 of each env sees drone 1 (seg id 101)
        seg = kernel_render.render_drones(
            tcfg.drone, render.landmark_scene(), ts.pos, ts.quat, n,
            depth_seg=True)[2]
        assert bool((seg[0::n] == 101).any(dim=(1, 2)).all())
    acts = 0.1 * np.random.default_rng(5).normal(
        size=(steps, b, n, adim)).astype(np.float32)
    before = kernel_render.launches
    for t in range(steps):
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(acts[t]))
        ts, to, tr, tte, ttr = t_step(ts, torch.from_numpy(acts[t]))
        assert to.shape == (b, n * IMG)
        assert_obs_close(to, jo)
        _close(tr, jr, f"reward t={t}")
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        _close(ts.pos, js.pos, f"pos t={t}")
        if t == 4:
            # the truncation, and the reset after it
            assert bool(ttr.all())
            np.testing.assert_array_equal(to.numpy(), tobs.numpy())
            assert int(ts.step_counter.max()) == 0
    assert kernel_render.launches == before     # CPU: the plain version


def test_fused_path_refuses_rgb():
    _, (tcfg, ttask) = _rgb_pair()
    with pytest.raises(ValueError, match="KIN"):
        tfast.fused_spec(tcfg, ttask)


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if getattr(x, "dtype", None) == jnp.float64 else x, tree)


@pytest.fixture(scope="module")
def jax_update():
    """One jitted JAX RGB PPO update from its float32 initial TrainState
    (compiled once for the module)."""
    (jcfg, jtask), _ = _rgb_pair(act="one_d_rpm", episode_len_sec=EPISODE_S)
    jp = jppo.PPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                        update_epochs=EPOCHS)
    init, update, _, _ = jppo.make_train(jcfg, jtask, jp)
    ts0 = _f32(jax.jit(init)(jax.random.key(0)))
    jts, jm = jax.jit(update)(ts0)
    return ts0, jts, jm


def _jax_draws(key, act_dim):
    """The rollout noise and the epoch permutations a JAX update draws."""
    noise, perms = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (E, act_dim),
                                                  jnp.float32)))
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, T)))
    return tppo.Draws(torch.from_numpy(np.stack(noise)),
                      torch.from_numpy(np.stack(perms)).long())


def test_one_rgb_update_matches_jax(jax_update):
    ts0, jts, jm = jax_update
    _, (tcfg, ttask) = _rgb_pair(act="one_d_rpm", episode_len_sec=EPISODE_S)
    tp = tppo.PPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                        update_epochs=EPOCHS)
    init, update, _, network = tppo.make_train(tcfg, ttask, tp, device="cpu")
    assert update.env_path == "batched"
    assert isinstance(network, ActorCriticCNN)
    ts = init(torch.Generator().manual_seed(0))
    assert isinstance(ts.network, ActorCriticCNN)
    start = convert.actor_critic_cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, ts0.params))
    ts.network.load_state_dict(start)
    assert_obs_close(ts.last_obs, ts0.last_obs)
    ts, tm = update(ts, _jax_draws(ts0.key, 1))
    assert ts.last_obs.shape == (E, IMG)
    assert_obs_close(ts.last_obs, jts.last_obs)
    for k in ("mean_reward", "mean_value", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    want = convert.actor_critic_cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, jts.params))
    got = ts.network.state_dict()
    moved = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        moved = max(moved, float((v - start[k]).abs().max()))
    assert moved > 100 * PARAM_ATOL


def test_make_train_rgb_needs_one_drone():
    _, (tcfg, ttask) = _rgb_pair("multihover")
    with pytest.raises(ValueError, match="one drone"):
        tppo.make_train(tcfg, ttask, tppo.PPOConfig(num_envs=2),
                        device="cpu")


def test_train_to_threshold_rgb_one_update(tmp_path):
    out = tmp_path / "curve.json"
    rc = train_to_threshold.main([
        "--rgb", "--device", "cpu", "--max_updates", "1", "--num_envs", "4",
        "--rollout_steps", "4", "--epochs", "1", "--lr", "1e-4",
        "--out", str(out)])
    got = json.loads(out.read_text())
    assert rc == 1 and not got["reached"]
    assert got["task"] == "hover_rgb" and got["obs_type"] == "rgb"
    assert got["physics"] == "dyn" and got["env_path"] == "batched"
    assert len(got["curve"]) == 1
    assert np.isfinite(got["curve"][0]["eval_return"])
