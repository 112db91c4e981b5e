"""Port envs/core.py and the per-env task methods against the JAX
package's: reset, step and step_autoreset of one env, and the same
functions broadcast over a leading batch axis."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import core as jcore
from gym_pybullet_drones_tpu_torch.envs import core as tcore

from tests._torch_helpers import (
    ATOL, PID_ATOL, RTOL, assert_obs_close, pair, routing_pair)


def _close(got, ref, msg="", atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("kind,act", [("hover", "rpm"),
                                      ("hover", "one_d_rpm"),
                                      ("multihover", "rpm"),
                                      ("hover", "pid"), ("hover", "vel"),
                                      ("hover", "one_d_pid"),
                                      ("routing", "pid")])
def test_reset_and_step_match_jax(kind, act):
    """The embedded-PID action types and the routing fleet go through
    `dsl_pid.compute_control` here; their tolerance is the JAX package's
    own for these paths (tests/test_fused.py:83-102, 5e-5 absolute)."""
    (jcfg, jtask), (tcfg, ttask) = routing_pair(3) if kind == "routing" \
        else pair(kind, act)
    atol = PID_ATOL if act in ("pid", "vel", "one_d_pid") else ATOL
    n = jcfg.num_drones
    act_dim = jtask.action_dim(jcfg)
    js, jobs, _ = jcore.reset(jcfg, jtask)
    ts, tobs, _ = tcore.reset(tcfg, ttask, device="cpu")
    assert tobs.shape == (n, ttask.obs_dim(tcfg))
    _close(tobs, jobs)
    _close(tcore.state_vector(ts), jcore.state_vector(js))
    assert all(leaf.shape == (n, 3) and not leaf.any()
               for leaf in ts.ctrl_state)
    j_step = jax.jit(lambda s, a: jcore.step(jcfg, jtask, s, a))
    rng = np.random.default_rng(2)
    for t in range(5):
        a = (0.5 * rng.normal(size=(n, act_dim))).astype(np.float32)
        js, jo, jr, jte, jtr, _ = j_step(js, jnp.asarray(a, jnp.float32))
        ts, to, tr, tte, ttr, _ = tcore.step(tcfg, ttask, ts,
                                             torch.from_numpy(a))
        _close(to, jo, f"obs t={t}", atol)
        _close(tr, jr, f"reward t={t}", atol)
        assert bool(tte) == bool(jte) and bool(ttr) == bool(jtr)
    assert int(ts.step_counter) == int(js.step_counter) == 40
    _close(ts.action_buffer, js.action_buffer)


@pytest.mark.parametrize("name", ["CtrlTask", "VelocityTask"])
def test_ctrl_and_velocity_tasks_match_jax(name):
    """The two non-RL tasks: raw rpm clipped to [0, max_rpm], and velocity
    commands through the embedded PID (a zero direction included); the
    20-value state vector as observation."""
    from gym_pybullet_drones_tpu.envs import tasks as jtasks
    from gym_pybullet_drones_tpu_torch.envs import tasks as ttasks
    (jcfg, _), (tcfg, _) = pair("multihover")
    jtask, ttask = getattr(jtasks, name)(), getattr(ttasks, name)()
    assert ttask.action_buffer_shape(tcfg) == (0, 4) \
        and ttask.obs_dim(tcfg) == 20
    js, jobs, _ = jcore.reset(jcfg, jtask)
    ts, tobs, _ = tcore.reset(tcfg, ttask, device="cpu")
    _close(tobs, jobs)
    rng = np.random.default_rng(3)
    for t in range(4):
        if name == "CtrlTask":
            a = rng.uniform(-2000, 26000, size=(2, 4)).astype(np.float32)
        else:
            a = rng.normal(size=(2, 4)).astype(np.float32)
            a[0, :3] *= t > 0                   # a zero direction at first
        js, jo, jr, jte, jtr, _ = jcore.step(jcfg, jtask, js,
                                             jnp.asarray(a, jnp.float32))
        ts, to, tr, tte, ttr, _ = tcore.step(tcfg, ttask, ts,
                                             torch.from_numpy(a))
        # the observation holds the rpm: RPM_TOL's relative part on those
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=PID_ATOL, err_msg=f"t={t}")
        assert float(tr) == float(jr) == -1.0
        assert not bool(tte) and not bool(ttr)
    assert float(ts.last_rpm.min()) >= 0.0 \
        and float(ts.last_rpm.max()) <= float(np.float32(tcfg.drone.max_rpm))


def test_step_autoreset_batched_matches_jax_vmap():
    """Leading batch dims written out here, vmap there; one env is started
    past the episode's end so that it truncates and resets."""
    (jcfg, jtask), (tcfg, ttask) = pair("multihover")
    b = 3
    js1, _, _ = jcore.reset(jcfg, jtask)
    js = jax.tree.map(lambda x: jnp.stack([x] * b), js1)
    js = js._replace(step_counter=jnp.asarray([0, 1928, 8], jnp.int32))
    ts1, _, _ = tcore.reset(tcfg, ttask, device="cpu")
    ts = tcore.map_leaves(lambda x: torch.stack([x] * b), ts1)
    ts = ts._replace(step_counter=torch.tensor([0, 1928, 8],
                                               dtype=torch.int32))
    a = (0.3 * np.random.default_rng(6).normal(size=(b, 2, 4))) \
        .astype(np.float32)
    jout = jax.vmap(lambda s, x: jcore.step_autoreset(jcfg, jtask, s, x))(
        js, jnp.asarray(a, jnp.float32))
    tout = tcore.step_autoreset(tcfg, ttask, ts, torch.from_numpy(a))
    assert tout[4].tolist() == np.asarray(jout[4]).tolist() \
        == [False, True, False]
    _close(tout[1], jout[1], "obs")
    _close(tout[2], jout[2], "reward")
    assert tout[0].step_counter.tolist() == [8, 0, 16]
    for k in ("pos", "quat", "vel", "last_rpm", "action_buffer"):
        _close(getattr(tout[0], k), getattr(jout[0], k), k)


def test_pyb_matches_jax_and_rgb_and_noise_raise():
    """PYB_DW and the routing configuration's default physics (PYB) step as
    in the JAX package; RGB observations give its camera image
    (tests/test_torch_rgb_slice.py holds them in full); a randomized
    auto-reset without the generator to draw it from raises
    (tests/test_torch_reset_noise.py holds randomized resets)."""
    import dataclasses
    from gym_pybullet_drones_tpu.envs import (
        make_routing_config as j_routing_config)
    from gym_pybullet_drones_tpu.utils import enums as JE
    from gym_pybullet_drones_tpu_torch.envs import (
        HoverTask, make_routing_config)
    from gym_pybullet_drones_tpu_torch.utils import enums as TE
    (jcfg, jtask), (tcfg, ttask) = pair()
    # the PYB family is ported: a reset and a step under PYB_DW give the
    # JAX package's result
    jdw = dataclasses.replace(jcfg, physics=JE.Physics.PYB_DW)
    tdw = dataclasses.replace(tcfg, physics=TE.Physics.PYB_DW)
    js, jobs, _ = jcore.reset(jdw, jtask)
    ts, tobs, _ = tcore.reset(tdw, ttask, device="cpu")
    _close(tobs, jobs)
    a = np.full((1, 4), 0.5, np.float32)
    _close(tcore.step(tdw, ttask, ts, torch.from_numpy(a))[1],
           jcore.step(jdw, jtask, js, jnp.asarray(a))[1], "PYB_DW step")
    ts, _, _ = tcore.reset(tcfg, ttask, device="cpu")
    # the routing configuration's default physics is PYB, as in the JAX
    # package, and it runs: the drones sink from their spawn under a zero
    # action's hold command as they do there
    rj, rt = j_routing_config(2), make_routing_config(2)
    assert rt[0].physics == TE.Physics.PYB
    js, jobs, _ = jcore.reset(*rj)
    rs, robs, _ = tcore.reset(*rt, device="cpu")
    _close(robs, jobs)
    a = np.zeros((2, 3), np.float32)
    jout = jcore.step(*rj, js, jnp.asarray(a))
    tout = tcore.step(*rt, rs, torch.from_numpy(a))
    _close(tout[1], jout[1], "routing PYB step", PID_ATOL)
    _close(tout[2], jout[2], "routing PYB reward", PID_ATOL)
    jrgb = jtask.__class__(obs=JE.ObservationType.RGB).compute_obs(
        jcfg, jcore.reset(jcfg, jtask)[0])
    trgb = HoverTask(obs=TE.ObservationType.RGB).compute_obs(tcfg, ts)
    assert trgb.shape == (1, 48, 64, 4) == jrgb.shape
    assert_obs_close(trgb, jrgb)
    noisy = HoverTask(reset_vel_noise=0.1)
    ns, _, _ = tcore.reset(tcfg, noisy, device="cpu")
    assert 0 < float(ns.vel.abs().max()) <= 0.1
    with pytest.raises(ValueError, match="generator"):
        tcore.step_autoreset(tcfg, noisy, ns, torch.zeros((1, 4)))
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg, ctrl_freq=50)
