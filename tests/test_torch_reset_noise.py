"""Randomized resets and `rpm_override` of the port against the JAX
package's.

The JAX package draws its reset noise with `jax.random`, which torch cannot
reproduce, so the draws are not held: the JAX draws are made here with the
calls of its `RLTask.randomize_reset` (`tasks.py:146-153`) and injected
into the port's draws-injected `randomize_reset`; the port's own draws are
held to their bounds and to their seeding; its batched paths are held to
select the randomized reset exactly where an env is done.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import core as jcore
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import (
    BatchedEnv, ResetNoise, core as tcore, make_batched_step)

from tests._torch_helpers import PID_ATOL, RTOL, pair, routing_pair

NOISE = dict(reset_pos_noise=0.2, reset_rpy_noise=0.1, reset_vel_noise=0.05)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread runs them fastest."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(key, n):
    """The uniforms JAX's randomize_reset draws from `key`, as the port's
    (n, 9) draws: the same split and uniform calls as its tasks.py."""
    kp, kr, kv = jax.random.split(key, 3)
    u = [jax.random.uniform(k, (n, 3), jnp.float32, -1.0, 1.0)
         for k in (kp, kr, kv)]
    return np.concatenate([np.asarray(x) for x in u], axis=-1)


@pytest.mark.parametrize("noise", [NOISE, dict(reset_pos_noise=0.3),
                                   dict(reset_rpy_noise=0.4)],
                         ids=["all", "pos", "rpy"])
@pytest.mark.parametrize("kind", ["multihover", "routing"])
def test_randomize_reset_matches_jax(kind, noise):
    (jcfg, jtask), (tcfg, ttask) = routing_pair(3) if kind == "routing" \
        else pair("multihover")
    # the deterministic reset (the JAX reset of a noisy task randomizes)
    js, _, _ = jcore.reset(jcfg, jtask, dtype=jnp.float32)
    jtask = dataclasses.replace(jtask, **noise)
    ttask = dataclasses.replace(ttask, **noise)
    n = jcfg.num_drones
    key = jax.random.PRNGKey(11)
    jout = jtask.randomize_reset(jcfg, js, key)
    ts = tcore.initial_state(tcfg, ttask, device="cpu")
    tout = ttask.randomize_reset(tcfg, ts,
                                 torch.from_numpy(_jax_draws(key, n)))
    for f in ("pos", "quat", "vel"):
        np.testing.assert_allclose(getattr(tout, f).numpy(),
                                   np.asarray(getattr(jout, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    for f in ("rpy_rates", "ang_v", "last_rpm", "action_buffer"):
        assert torch.equal(getattr(tout, f), getattr(ts, f))


def test_port_draws_bounds_and_seeding():
    """Uniforms in [-1, 1), one seed the same numbers twice, two seeds
    others; a stream's draw k is the same whatever was asked before; the
    reset states lie within the noise of the deterministic reset."""
    g = lambda s: torch.Generator().manual_seed(s)
    u = tcore.reset_draws(g(3), (4096, 2), "cpu")
    assert u.shape == (4096, 2, 9) and u.dtype == torch.float32
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
    assert float(u.min()) < -0.99 and float(u.max()) > 0.99
    assert torch.equal(u, tcore.reset_draws(g(3), (4096, 2), "cpu"))
    assert not torch.equal(u, tcore.reset_draws(g(4), (4096, 2), "cpu"))
    a, b = ResetNoise(5, (16, 2), "cpu"), ResetNoise(5, (16, 2), "cpu")
    first = [a.next() for _ in range(ResetNoise.BLOCK + 3)]
    second = [b.next() for _ in range(ResetNoise.BLOCK + 3)]
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert not torch.equal(first[0], first[1])
    assert not torch.equal(first[0], ResetNoise(6, (16, 2), "cpu").next())
    _, (tcfg, ttask) = pair("multihover")
    ttask = dataclasses.replace(ttask, **NOISE)
    base = tcore.initial_state(tcfg, ttask, device="cpu")
    s, obs, _ = tcore.reset(tcfg, ttask, device="cpu", generator=g(1),
                            batch_shape=(512,))
    assert obs.shape == (512, 2, ttask.obs_dim(tcfg))
    assert float((s.pos - base.pos).abs().max()) <= 0.2 + 1e-6
    assert float(s.vel.abs().max()) <= 0.05 + 1e-6
    from gym_pybullet_drones_tpu_torch.ops import quat as tquat
    assert float(tquat.quat_to_rpy(s.quat).abs().max()) <= 0.1 + 1e-6
    assert float((s.pos - base.pos).abs().max()) > 0.19
    # generator=None is seed 0, as the JAX package's PRNGKey(0)
    s0 = tcore.reset(tcfg, ttask, device="cpu")[0]
    assert torch.equal(s0.pos, tcore.reset(tcfg, ttask, device="cpu",
                                           generator=g(0))[0].pos)


def test_zero_noise_reset_is_unchanged():
    """A task without noise draws nothing and resets bit for bit as the
    deterministic reset, on every path; its batched reset ignores the
    seed."""
    _, (tcfg, ttask) = pair("multihover")
    gen = torch.Generator().manual_seed(9)
    before = gen.get_state()
    s, obs, _ = tcore.reset(tcfg, ttask, device="cpu", generator=gen)
    assert torch.equal(gen.get_state(), before)
    base = tcore.initial_state(tcfg, ttask, device="cpu")
    for f in ("pos", "quat", "vel", "action_buffer"):
        assert torch.equal(getattr(s, f), getattr(base, f))
    assert ttask.randomize_reset(tcfg, base, None) is base
    reset_fn, step_fn = make_batched_step(tcfg, ttask, 4, device="cpu")
    (s0, o0), (s5, o5) = reset_fn(0), reset_fn(5)
    assert torch.equal(s0.pos, s5.pos) and torch.equal(o0, o5)
    assert torch.equal(s0.pos, base.pos.repeat(4, 1))
    assert torch.equal(o0, obs.expand(4, -1, -1))
    assert step_fn.reset_noise() is None


@pytest.mark.parametrize("kind", ["hover", "routing"])
def test_rpm_override_matches_jax(kind):
    """`core.step(rpm_override=...)` applies the rpm as it is: the action
    buffer is not pushed and the embedded PID does not tick."""
    (jcfg, jtask), (tcfg, ttask) = routing_pair(3) if kind == "routing" \
        else pair("hover")
    n = jcfg.num_drones
    js, _, _ = jcore.reset(jcfg, jtask, dtype=jnp.float32)
    # a state with history and PID rows to leave alone
    act = np.full((n, jtask.action_dim(jcfg)), 0.3, np.float32)
    js = jcore.step(jcfg, jtask, js, jnp.asarray(act))[0]
    ts = convert.env_state_from_numpy(js._asdict(), device="cpu")
    rpm = (jcfg.drone.hover_rpm * (1.0 + 0.01 * np.arange(4 * n).reshape(
        n, 4))).astype(np.float32)
    jout = jcore.step(jcfg, jtask, js, None, rpm_override=jnp.asarray(rpm))
    tout = tcore.step(tcfg, ttask, ts, None,
                      rpm_override=torch.from_numpy(rpm))
    atol = PID_ATOL if kind == "routing" else 2e-5
    for a, b, what in ((tout[1], jout[1], "obs"), (tout[2], jout[2],
                                                   "reward")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=atol, err_msg=what)
    assert bool(tout[3]) == bool(jout[3]) and bool(tout[4]) == bool(jout[4])
    np.testing.assert_array_equal(tout[0].last_rpm.numpy(), rpm)
    assert torch.equal(tout[0].action_buffer, ts.action_buffer)
    for t, s in zip(tout[0].ctrl_state, ts.ctrl_state):
        assert torch.equal(t, s)
    assert int(tout[0].step_counter) == int(jout[0].step_counter)


def test_batched_step_rerandomizes_done_envs():
    """make_batched_step with reset noise: the envs done at a step take the
    reset moved by that step's draw, the others the stepped state; the
    draws are ResetNoise(seed)'s, one a step."""
    _, (tcfg, ttask) = pair("hover")
    ttask = dataclasses.replace(ttask, **NOISE)
    b = 16
    reset_fn, step_fn = make_batched_step(tcfg, ttask, b, device="cpu")
    _, free_step = make_batched_step(tcfg, ttask, b, autoreset=False,
                                     device="cpu")
    stream = ResetNoise(3, (b,), "cpu")
    state, obs = reset_fn(3)
    # the constant flat reset of the same task without noise
    init = make_batched_step(tcfg, dataclasses.replace(
        ttask, reset_pos_noise=0.0, reset_rpy_noise=0.0,
        reset_vel_noise=0.0), b, device="cpu")[0]()[0]
    draw0 = stream.next()
    assert torch.equal(state.pos, ttask.randomize_reset(tcfg, init,
                                                        draw0).pos)
    tilt = torch.tensor([1.0, 1.0, -1.0, -1.0]).expand(b, 1, 4)
    seen_mixed = False
    for t in range(40):
        draw = stream.next()
        nxt, nobs, _, nte, ntr = free_step(state, tilt)
        state, obs, _, te, tr = step_fn(state, tilt)
        done = te | tr
        assert torch.equal(done, nte | ntr)
        redo = ttask.randomize_reset(tcfg, init, draw)
        for f in ("pos", "quat", "vel", "ang_v", "last_rpm"):
            want = torch.where(done[:, None], getattr(redo, f),
                               getattr(nxt, f))
            assert torch.equal(getattr(state, f), want), (t, f)
        assert torch.equal(state.step_counter,
                           torch.where(done, 0, nxt.step_counter))
        seen_mixed |= bool(done.any() & ~done.all())
    assert seen_mixed
    assert step_fn.reset_noise().index == 41


def _decorrelation_checks(reset, step, b):
    """tests/test_envs.py::test_randomized_resets_decorrelate_envs's
    assertions on (reset(seed) -> state, step(state, a) -> state)."""
    state = reset(3)
    spread = float(state.pos.reshape(b, -1, 3)[:, 0, 0].std())
    assert spread > 0.01
    a = torch.tensor([1.0, 1.0, -1.0, -1.0]).expand(b, 1, 4)
    for _ in range(60):
        state = step(state, a)
    assert float(state.pos.reshape(b, -1, 3)[:, 0, 0].std()) > 0.001


@pytest.mark.parametrize("path", ["BatchedEnv", "make_batched_step"])
def test_randomized_resets_decorrelate_envs(path):
    from gym_pybullet_drones_tpu_torch import params as TP
    from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask
    from gym_pybullet_drones_tpu_torch.utils.enums import (
        ActionType, Physics)
    cfg = AviaryConfig(drone=TP.CF2X, num_drones=1, physics=Physics.DYN,
                       pyb_freq=240, ctrl_freq=30)
    noisy = HoverTask(act=ActionType.RPM, reset_pos_noise=0.2,
                      reset_rpy_noise=0.1)
    plain = HoverTask(act=ActionType.RPM)
    b = 16
    if path == "BatchedEnv":
        make = lambda task: BatchedEnv(cfg, task, b, device="cpu")
        env = make(noisy)
        _decorrelation_checks(lambda s: env.reset(seed=s)[0],
                              lambda st, a: env.step(st, a)[0], b)
        s2 = make(plain).reset(seed=3)[0]
    else:
        reset_fn, step_fn = make_batched_step(cfg, noisy, b, device="cpu")
        _decorrelation_checks(lambda s: reset_fn(s)[0],
                              lambda st, a: step_fn(st, a)[0], b)
        s2 = make_batched_step(cfg, plain, b, device="cpu")[0](3)[0]
    # the default task: deterministic, reference parity
    assert float(s2.pos.reshape(b, -1, 3)[:, 0, 0].std()) == 0.0
    np.testing.assert_allclose(float(s2.pos.reshape(b, -1, 3)[0, 0, 2]),
                               TP.CF2X.init_z, atol=1e-6)
    if path == "BatchedEnv":
        with pytest.raises(ValueError, match="generator"):
            tcore.step_autoreset(cfg, noisy, s2, torch.zeros(b, 1, 4))
