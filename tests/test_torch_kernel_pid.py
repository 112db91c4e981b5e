"""The plain PyTorch version of the `pid_dyn_ctrl_step` kernel against the
JAX package: once against the Pallas kernel in interpret mode (B = 16, as
tests/test_pallas.py runs it on the CPU), else against the XLA chain
`dsl_pid.compute_control` + eight `dyn_step`s, with the tolerances of
tests/test_pallas.py:154-164 (rpm rtol 2e-5 / atol 0.5, state rtol 3e-4 /
atol 3e-5, PID rows rtol 3e-4 / atol 2e-5).  On the CPU the wrapper runs the
plain version; the CUDA kernel is held against the same plain version on
the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_pybullet_drones_tpu.control import dsl_pid as jpid
from gym_pybullet_drones_tpu.ops import pallas_pid
from gym_pybullet_drones_tpu.ops.dynamics import (
    DynState as JDynState, dyn_step as j_dyn_step)
from gym_pybullet_drones_tpu_torch.control import dsl_pid as tpid
from gym_pybullet_drones_tpu_torch.ops import kernel_pid
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState as TDynState

from tests._torch_helpers import (
    PID_ROWS_TOL, PID_STATE_TOL, RPM_TOL, models, rand_dyn, rand_pid,
    rand_targets)

DT, CTRL_DT, SUB = 1 / 240, 1 / 30, 8
FIELDS = ("pos", "quat", "vel", "rpy_rates", "ang_v")


def _inputs(b, seed):
    return (rand_dyn(b, seed), rand_pid(b, seed + 1),
            rand_targets(b, seed + 2))


def _port(tpm, tdm, leaves, pid, tgts, emit_obs12=False, n_substeps=SUB):
    t = torch.from_numpy
    before = kernel_pid.launches
    out = kernel_pid.pid_dyn_ctrl_step(
        tpm, tdm, TDynState(*(t(a) for a in leaves)),
        tpid.PIDState(*(t(a) for a in pid)), n_substeps, DT, CTRL_DT,
        *(t(a) for a in tgts), emit_obs12)
    assert kernel_pid.launches == before     # a CPU tensor launches nothing
    return out


def _hold(out, jstate, jpid_state, jrpm):
    state, new_pid, rpm = out[:3]
    np.testing.assert_allclose(rpm.numpy(), np.asarray(jrpm), **RPM_TOL)
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(state, name).numpy(), np.asarray(getattr(jstate, name)),
            err_msg=name, **PID_STATE_TOL)
    for name in tpid.PIDState._fields:
        np.testing.assert_allclose(
            getattr(new_pid, name).numpy(),
            np.asarray(getattr(jpid_state, name)), err_msg=name,
            **PID_ROWS_TOL)


def test_plain_pid_dyn_ctrl_step_matches_pallas_interpret():
    """B = 16 pads to one 128-lane kernel block, the shape of
    tests/test_pallas.py's case; the time is the interpretation, not the
    batch."""
    b = 16
    jm, tm = models("cf2x")
    leaves, pid, tgts = _inputs(b, seed=4)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    jstate, jnew, jrpm = pallas_pid.pid_dyn_ctrl_step(
        jm, jm, JDynState(*(f32(a) for a in leaves)),
        jpid.PIDState(*(f32(a) for a in pid)), SUB, DT, CTRL_DT,
        *(f32(a) for a in tgts))
    _hold(_port(tm, tm, leaves, pid, tgts), jstate, jnew, jrpm)


@pytest.mark.parametrize("pid_model,dyn_model", [
    ("cf2x", "cf2x"), ("cf2x", "cf2p"), ("cf2x", "racer"), ("cf2p", "cf2p")])
def test_plain_pid_dyn_ctrl_step_matches_xla_chain(pid_model, dyn_model):
    """The controller's model apart from the dynamics' (the env paths pass
    the CF2X controller over any drone) and the CF2P PWM mixer."""
    b = 64
    (jpm, tpm), (jdm, tdm) = models(pid_model), models(dyn_model)
    leaves, pid, tgts = _inputs(b, seed=20)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    ref = JDynState(*(f32(a) for a in leaves))
    jrpm, jnew, _, _ = jpid.compute_control(
        jpm, jpid.PIDState(*(f32(a) for a in pid)), CTRL_DT,
        cur_pos=ref.pos, cur_quat=ref.quat, cur_vel=ref.vel,
        target_pos=f32(tgts[0]), target_rpy=f32(tgts[1]),
        target_vel=f32(tgts[2]), target_rpy_rates=f32(tgts[3]))
    for _ in range(SUB):
        ref = j_dyn_step(jdm, ref, jrpm, DT)
    _hold(_port(tpm, tdm, leaves, pid, tgts), ref, jnew, jrpm)


def test_plain_pid_dyn_ctrl_step_matches_xla_chain_one_substep():
    """One substep a control step (240 Hz control): the tick and one
    `dyn_step`, at the tolerances of the eight-substep chain."""
    b = 16
    jm, tm = models("cf2x")
    leaves, pid, tgts = _inputs(b, seed=40)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    ref = JDynState(*(f32(a) for a in leaves))
    jrpm, jnew, _, _ = jpid.compute_control(
        jm, jpid.PIDState(*(f32(a) for a in pid)), CTRL_DT,
        cur_pos=ref.pos, cur_quat=ref.quat, cur_vel=ref.vel,
        target_pos=f32(tgts[0]), target_rpy=f32(tgts[1]),
        target_vel=f32(tgts[2]), target_rpy_rates=f32(tgts[3]))
    ref = j_dyn_step(jm, ref, jrpm, DT)
    _hold(_port(tm, tm, leaves, pid, tgts, n_substeps=1), ref, jnew, jrpm)


def test_tick_stays_finite_for_a_horizontal_thrust_vector():
    """A far target along +x makes the normalised thrust axis (1, 0, ~0):
    the asin argument sits at 1 to the last bit, and `asin` gives NaN for 1
    + 1 ulp, so the tick clips it."""
    _, tm = models("cf2x")
    b = 256
    rng = np.random.default_rng(8)
    pos, quat, vel, _, _ = rand_dyn(b, seed=9)
    tgt = np.zeros((12, b), np.float32)
    tgt[0:3] = pos.T + np.stack([10.0 ** rng.uniform(2, 6, size=b),
                                 rng.normal(size=b) * 1e-3,
                                 rng.normal(size=b) * 1e-3]).astype(np.float32)
    rows = [torch.from_numpy(np.ascontiguousarray(r))
            for r in np.concatenate([pos, quat, vel], axis=-1).T]
    rpm, new_pid = kernel_pid.pid_tick_rows(
        tm, CTRL_DT, rows, list(torch.zeros((9, b))),
        list(torch.from_numpy(tgt)))
    assert all(torch.isfinite(r).all() for r in rpm + list(new_pid))
    # and the clip itself: an argument of 1 + 1 ulp would be NaN
    assert torch.isnan(torch.asin(torch.tensor(1.0000001)))


def test_rows_entry_and_obs12():
    """The rows-level entry returns row blocks; obs12 is [pos, rpy, vel,
    ang_v] of the stepped state."""
    _, tm = models("cf2x")
    b = 8
    leaves, pid, tgts = _inputs(b, seed=30)
    rows = lambda arrs: torch.from_numpy(np.ascontiguousarray(
        np.concatenate(arrs, axis=-1).T))
    out, new_pid, rpm, obs12 = kernel_pid.pid_dyn_ctrl_step_rows(
        tm, tm, rows(leaves), rows(pid), rows(tgts), SUB, DT, CTRL_DT, True)
    assert (out.shape, new_pid.shape, rpm.shape, obs12.shape) \
        == ((16, b), (9, b), (4, b), (12, b))
    assert torch.equal(obs12[0:3], out[0:3])
    assert torch.equal(obs12[6:9], out[7:10])
    assert torch.equal(obs12[9:12], out[13:16])
    # last_rpy of the new PID rows is the PRE-step attitude
    from gym_pybullet_drones_tpu_torch.ops import quat as tq
    np.testing.assert_allclose(
        new_pid[0:3].t().numpy(),
        tq.quat_to_rpy(torch.from_numpy(leaves[1])).numpy(), atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "pid_rows", "tgt_width",
                                 "contiguous", "substeps", "pid_model"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    _, tm = models("cf2x")
    _, race = models("racer")
    s = torch.zeros((16, 8))
    s[6] = 1.0
    pid, tgt, n, pm = torch.zeros((9, 8)), torch.zeros((12, 8)), 8, tm
    if bad == "dtype":
        pid = pid.double()
    elif bad == "pid_rows":
        pid = torch.zeros((8, 8))
    elif bad == "tgt_width":
        tgt = torch.zeros((12, 4))
    elif bad == "contiguous":
        s = torch.zeros((8, 16)).t()
    elif bad == "substeps":
        n = 0
    else:
        pm = race
    with pytest.raises((TypeError, ValueError)):
        kernel_pid.pid_dyn_ctrl_step_rows(pm, tm, s, pid, tgt, n, DT, CTRL_DT)
