"""The port as a whole against the JAX package: both of the port's
rollout entry points over a full zero-action Hover episode (truncation on
control step 242, the reset after it), both packages continued from one
mid-rollout state carried across through convert.py, and the same for the
embedded-PID paths: Hover with PID-family actions and the routing fleet
(zero-action episode to its timeout on step 482, PID carry across)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import fast as jfast
from gym_pybullet_drones_tpu.ops import pallas_fused
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import fast as tfast
from gym_pybullet_drones_tpu_torch.ops import kernel_fused

from tests._torch_helpers import (
    ATOL, PID_ATOL, PID_ROWS_TOL, RPM_TOL, RTOL, pair, routing_pair)

LEAVES = ("pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm",
          "action_buffer", "step_counter")


def _j_batched(kind, b):
    (jcfg, jtask), _ = pair(kind)
    reset, step = jfast.make_batched_step(jcfg, jtask, b, use_pallas=False,
                                          obs_layout="flat")
    return reset, jax.jit(step)


def _close(got, ref, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_zero_action_episode_matches_jax():
    b, steps = 4, 300
    (jcfg, _), (tcfg, ttask) = pair("hover")
    j_reset, j_step = _j_batched("hover", b)
    f_reset, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    b_reset, b_step = tfast.make_batched_step(tcfg, ttask, b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    fc, fobs = f_reset()
    bs, bobs = b_reset()
    _close(fobs, jobs)
    _close(bobs, jobs)
    ja = jnp.zeros((b, 1, 4), jnp.float32)
    ta = torch.zeros((b, 1, 4))
    trunc_steps = []
    for t in range(1, steps + 1):
        js, jo, jr, jte, jtr = j_step(js, ja)
        fc, fo, fr, fte, ftr = f_step(fc, ta)
        bs, bo, br, bte, btr = b_step(bs, ta)
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _close(r, jr, f"reward t={t}")
            _close(o, jo, f"obs t={t}")
        if bool(ftr.any()):
            assert bool(ftr.all())
            trunc_steps.append(t)
            # the reset after it: obs is the initial obs, counters are zero
            _close(fo, jobs)
            assert torch.equal(bs.step_counter,
                               torch.zeros(b, dtype=torch.int32))
            assert torch.all(fc[-1] == 0)
        # a symmetric hover stays bitwise symmetric on both of the
        # port's paths: x = y = 0 and the identity quaternion
        assert torch.all(fo[:, 0:2] == 0) and torch.all(bo[:, 0:2] == 0)
        assert torch.equal(fc[3:7], torch.tensor([[0.], [0.], [0.], [1.]])
                           .expand(4, b))
        assert torch.all(fr == fr[0])
    assert trunc_steps == [242]
    assert int(bs.step_counter[0]) == (steps - 242) * 8
    assert np.array_equal(np.asarray(js.step_counter),
                          bs.step_counter.numpy())


@pytest.mark.parametrize("kind", ["hover", "multihover"])
def test_continue_from_a_carried_jax_state(kind):
    """JAX runs 6 steps; its state goes through convert.py into both of the
    port's carries; all three continue on the same actions and agree.  Then
    the port's state goes back and the JAX package continues from it."""
    b = 4
    (jcfg, jtask), (tcfg, ttask) = pair(kind)
    n = jcfg.num_drones
    rng = np.random.default_rng(9)
    acts = (0.6 * rng.normal(size=(12, b, n, 4))).astype(np.float32)
    j_reset, j_step = _j_batched(kind, b)
    js, _ = j_reset()
    for t in range(6):
        js = j_step(js, jnp.asarray(acts[t], jnp.float32))[0]
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES}
    assert leaves["pos"].dtype == np.float32

    _, b_step = tfast.make_batched_step(tcfg, ttask, b, obs_layout="flat",
                                        device="cpu")
    _, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    bs = convert.env_state_from_numpy(leaves, device="cpu")
    assert bs.step_counter.dtype == torch.int32
    jcarry = np.asarray(pallas_fused.pack_carry(leaves, n, 60, b, jtask.act))
    assert jcarry.shape[1] == 128                     # lane padding
    fc = convert.fused_carry_from_numpy(jcarry, b, device="cpu")
    assert fc.shape == (n * 80 + 1, b)
    np.testing.assert_array_equal(convert.fused_carry_to_numpy(fc), jcarry)

    for t in range(6, 12):
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(acts[t], jnp.float32))
        bs, bo, br, bte, btr = b_step(bs, torch.from_numpy(acts[t]))
        fc, fo, fr, fte, ftr = f_step(fc, torch.from_numpy(acts[t]))
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _close(r, jr, f"reward t={t}")
            _close(o, jo, f"obs t={t}")
    for k in LEAVES:
        _close(getattr(bs, k), getattr(js, k), k)

    # and back: the JAX package continues from the port's state
    back = convert.env_state_to_numpy(bs)
    js2 = js._replace(**{k: jnp.asarray(back[k]) for k in LEAVES})
    a = jnp.zeros((b, n, 4), jnp.float32)
    out1, out2 = j_step(js, a), j_step(js2, a)
    np.testing.assert_allclose(np.asarray(out2[1]), np.asarray(out1[1]),
                               rtol=RTOL, atol=ATOL)


def test_entry_points_refuse_to_run_without_a_card():
    """device=None means the CUDA card: where there is none the entry
    points raise, they do not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (tcfg, ttask) = pair("hover")
    for make in (tfast.make_fused_rollout, tfast.make_batched_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(tcfg, ttask, 4)
    # the helpers that build tensors follow the same rule
    leaves = {"pos": np.zeros((2, 3), np.float32),
              "quat": np.zeros((2, 4), np.float32),
              "vel": np.zeros((2, 3), np.float32),
              "rpy_rates": np.zeros((2, 3), np.float32),
              "ang_v": np.zeros((2, 3), np.float32),
              "last_rpm": np.zeros((2, 4), np.float32),
              "action_buffer": np.zeros((2, 60), np.float32),
              "step_counter": np.zeros((2,), np.float32)}
    for call in (tcfg.default_init_xyzs, tcfg.default_init_rpys,
                 lambda: kernel_fused.pack_carry(leaves, 1, 60, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert kernel_fused.pack_carry(leaves, 1, 60, 2, device="cpu").shape \
        == (81, 2)


# ---- the embedded-PID paths: Hover PID / VEL / ONE_D_PID and routing ----
# Tolerance of tests/test_fused.py:83-102 for these paths: 5e-5 absolute and
# 1e-4 relative on observations and reward, flags equal.

PID_LEAVES = ("last_rpy", "integral_pos_e", "integral_rpy_e")


def _pid_close(got, ref, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=PID_ATOL, err_msg=msg)


@pytest.mark.parametrize("act", ["pid", "vel", "one_d_pid"])
def test_batched_pid_family_matches_jax(act):
    """HoverTask with an embedded-PID action type through make_batched_step
    (one `pid_dyn_ctrl_step` per control step) against the XLA path."""
    b = 8
    (jcfg, jtask), (tcfg, ttask) = pair("hover", act)
    act_dim = jtask.action_dim(jcfg)
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    t_reset, t_step = tfast.make_batched_step(tcfg, ttask, b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    ts, tobs = t_reset()
    _pid_close(tobs, jobs)
    rng = np.random.default_rng(11)
    for t in range(6):
        a = (0.3 * rng.normal(size=(b, 1, act_dim))).astype(np.float32)
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(a, jnp.float32))
        ts, to, tr, tte, ttr = t_step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        _pid_close(tr, jr, f"reward t={t}")
        _pid_close(to, jo, f"obs t={t}")
    np.testing.assert_allclose(ts.last_rpm.numpy(), np.asarray(js.last_rpm),
                               **RPM_TOL)
    for k in PID_LEAVES:
        np.testing.assert_allclose(
            getattr(ts.ctrl_state, k).numpy(),
            np.asarray(getattr(js.ctrl_state, k)), err_msg=k, **PID_ROWS_TOL)


def test_batched_velocity_task_matches_jax():
    """VelocityTask has no kernel setpoints: make_batched_step runs its
    embedded PID as tensor code on the flat carry (`compute_control`) and
    the physics through `dyn_ctrl_step`."""
    from gym_pybullet_drones_tpu.envs.tasks import VelocityTask as JVel
    from gym_pybullet_drones_tpu_torch.envs import VelocityTask as TVel
    b, n = 4, 2
    (jcfg, _), (tcfg, _) = pair("multihover")
    j_reset, j_step = jfast.make_batched_step(jcfg, JVel(), b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    t_reset, t_step = tfast.make_batched_step(tcfg, TVel(), b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    ts, tobs = t_reset()
    assert tobs.shape == (b, n * 20)
    _pid_close(tobs, jobs)
    rng = np.random.default_rng(13)
    for t in range(4):
        a = rng.normal(size=(b, n, 4)).astype(np.float32)
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(a, jnp.float32))
        ts, to, tr, tte, ttr = t_step(ts, torch.from_numpy(a))
        _pid_close(to, jo, f"obs t={t}")       # the 20 values hold the rpm
        assert not tte.any() and not ttr.any() and torch.all(tr == -1.0)
    for k in PID_LEAVES:
        np.testing.assert_allclose(
            getattr(ts.ctrl_state, k).numpy(),
            np.asarray(getattr(js.ctrl_state, k)), err_msg=k, **PID_ROWS_TOL)


def test_routing_zero_action_episode_matches_jax():
    """A zero action commands each drone's own position: the fleet holds its
    line for the 16 s episode, which times out on control step 482 (the
    first to start with more than 3840 substeps on its counter) and on no
    other; both of the port's paths against the XLA path.  To keep the test
    short, the counters of all three are moved from step 60 to step 440
    (the hover is steady by then; the state is left as it is)."""
    b, n, skip_from, skip_to, last = 2, 2, 60, 440, 484
    (jcfg, jtask), (tcfg, ttask) = routing_pair(n)
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    f_reset, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    b_reset, b_step = tfast.make_batched_step(tcfg, ttask, b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    fc, fobs = f_reset()
    bs, bobs = b_reset()
    ja = jnp.zeros((b, n, 3), jnp.float32)
    ta = torch.zeros((b, n, 3))
    trunc_steps = []
    steps = list(range(1, skip_from + 1)) + list(range(skip_to + 1, last + 1))
    for t in steps:
        if t == skip_to + 1:
            assert int(bs.step_counter[0]) == int(fc[-1, 0]) == skip_from * 8
            js = js._replace(step_counter=js.step_counter * 0 + skip_to * 8)
            bs = bs._replace(step_counter=bs.step_counter * 0 + skip_to * 8)
            fc = fc.clone()
            fc[-1] = float(skip_to * 8)
        js, jo, jr, jte, jtr = j_step(js, ja)
        fc, fo, fr, fte, ftr = f_step(fc, ta)
        bs, bo, br, bte, btr = b_step(bs, ta)
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _pid_close(r, jr, f"reward t={t}")
            _pid_close(o, jo, f"obs t={t}")
        if bool(ftr.any()):
            assert bool(ftr.all())
            trunc_steps.append(t)
            _pid_close(fo, jobs)
            # the reset zeroes last_rpm, the PID rows, the ring, the counter
            assert not fc[16:74].any() and not fc[-1].any()
            assert not any(leaf.any() for leaf in bs.ctrl_state)
    assert trunc_steps == [482]
    assert bs.step_counter.tolist() == [16, 16]


def test_routing_continue_from_a_carried_jax_state():
    """JAX runs 5 routing steps; its state, PID carry included, goes through
    convert.py into both of the port's carries; all three continue on the
    same actions and agree.  The port's fused carry opens into the batched
    path's state, and the port's state goes back to the JAX package."""
    b, n = 4, 3
    (jcfg, jtask), (tcfg, ttask) = routing_pair(n)
    rng = np.random.default_rng(12)
    acts = (0.3 * rng.normal(size=(10, b, n, 3))).astype(np.float32)
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    js, _ = j_reset()
    for t in range(5):
        js = j_step(js, jnp.asarray(acts[t], jnp.float32))[0]
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES}
    leaves["ctrl_state"] = {k: np.asarray(getattr(js.ctrl_state, k))
                            for k in PID_LEAVES}
    assert leaves["ctrl_state"]["last_rpy"].dtype == np.float32
    assert leaves["ctrl_state"]["integral_pos_e"].any()

    _, b_step = tfast.make_batched_step(tcfg, ttask, b, obs_layout="flat",
                                        device="cpu")
    _, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    bs = convert.env_state_from_numpy(leaves, device="cpu")
    np.testing.assert_array_equal(bs.ctrl_state.integral_rpy_e.numpy(),
                                  leaves["ctrl_state"]["integral_rpy_e"])
    # without the PID leaves the controllers start from zero
    no_pid = {k: v for k, v in leaves.items() if k != "ctrl_state"}
    assert not any(leaf.any() for leaf in convert.env_state_from_numpy(
        no_pid, device="cpu").ctrl_state)
    jleaves = dict(no_pid, pid=np.concatenate(
        [leaves["ctrl_state"][k] for k in PID_LEAVES], axis=-1))
    jcarry = np.asarray(pallas_fused.pack_carry(jleaves, n, 45, b, jtask.act))
    assert jcarry.shape == (297 - 74, 128)            # 3 drones, lane padding
    fc = convert.fused_carry_from_numpy(jcarry, b, device="cpu")
    assert fc.shape == (n * 74 + 1, b)
    np.testing.assert_array_equal(convert.fused_carry_to_numpy(fc), jcarry)
    # the fused carry opened: the batched path's state, leaf for leaf
    opened = convert.env_state_from_fused_carry(fc, n, ttask.act)
    for k in LEAVES:
        assert torch.equal(getattr(opened, k), getattr(bs, k)), k
    for k in PID_LEAVES:
        assert torch.equal(getattr(opened.ctrl_state, k),
                           getattr(bs.ctrl_state, k)), k

    for t in range(5, 10):
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(acts[t], jnp.float32))
        bs, bo, br, bte, btr = b_step(bs, torch.from_numpy(acts[t]))
        fc, fo, fr, fte, ftr = f_step(fc, torch.from_numpy(acts[t]))
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _pid_close(r, jr, f"reward t={t}")
            _pid_close(o, jo, f"obs t={t}")
    np.testing.assert_allclose(bs.last_rpm.numpy(), np.asarray(js.last_rpm),
                               **RPM_TOL)
    for k in PID_LEAVES:
        np.testing.assert_allclose(
            getattr(bs.ctrl_state, k).numpy(),
            np.asarray(getattr(js.ctrl_state, k)), err_msg=k, **PID_ROWS_TOL)

    # and back: the JAX package continues from the port's state
    back = convert.env_state_to_numpy(bs)
    js2 = js._replace(
        ctrl_state=type(js.ctrl_state)(
            **{k: jnp.asarray(back["ctrl_state"][k]) for k in PID_LEAVES}),
        **{k: jnp.asarray(back[k]) for k in LEAVES})
    a = jnp.zeros((b, n, 3), jnp.float32)
    out1, out2 = j_step(js, a), j_step(js2, a)
    np.testing.assert_allclose(np.asarray(out2[1]), np.asarray(out1[1]),
                               rtol=RTOL, atol=PID_ATOL)
