"""Port control/dsl_pid.py against the JAX package's: one tick on seeded
inputs, a 30-tick closed loop with the DYN physics (against JAX and the
float64 golden trajectory `tests/golden/pid_closedloop_cf2x.npz`), and the
reference-style wrapper.  Tolerances: float64 1e-9 relative (same formulas,
other summation order in the 3x3 products); float32 the JAX package's own
for this controller, tests/test_pallas.py:154-164 (rpm rtol 2e-5 / atol
0.5, PID rows rtol 3e-4 / atol 2e-5)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.control import dsl_pid as jpid
from gym_pybullet_drones_tpu.ops.dynamics import (
    DynState as JDynState, dyn_step as j_dyn_step)
from gym_pybullet_drones_tpu_torch.control import dsl_pid as tpid
from gym_pybullet_drones_tpu_torch.ops.dynamics import (
    DynState as TDynState, dyn_step as t_dyn_step)
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel

from tests._torch_helpers import (
    PID_ROWS_TOL, RPM_TOL, models, rand_dyn, rand_pid, rand_targets)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "pid_closedloop_cf2x.npz")
B = 32


def _tick_inputs(dtype):
    pos, quat, vel, _, _ = rand_dyn(B, seed=4, dtype=dtype)
    return (pos, quat, vel) + rand_targets(B, seed=5, dtype=dtype), \
        rand_pid(B, seed=6, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", ["cf2x", "cf2p"])
def test_compute_control_matches_jax(model, dtype):
    jm, tm = models(model)
    (pos, quat, vel, tp, trpy, tv, trr), pid = _tick_inputs(dtype)
    jrpm, jnew, jpos_e, jyaw_e = jpid.compute_control(
        jm, jpid.PIDState(*(jnp.asarray(a) for a in pid)), 1 / 30,
        jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(vel),
        jnp.asarray(tp), jnp.asarray(trpy), jnp.asarray(tv),
        jnp.asarray(trr))
    t = torch.from_numpy
    trpm, tnew, tpos_e, tyaw_e = tpid.compute_control(
        tm, tpid.PIDState(*(t(a) for a in pid)), 1 / 30, t(pos), t(quat),
        t(vel), t(tp), t(trpy), t(tv), t(trr))
    assert trpm.numpy().dtype == dtype and np.asarray(jrpm).dtype == dtype
    rpm_tol = RPM_TOL if dtype == np.float32 else dict(rtol=1e-9, atol=0)
    rows_tol = PID_ROWS_TOL if dtype == np.float32 \
        else dict(rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), **rpm_tol)
    for name in tpid.PIDState._fields:
        np.testing.assert_allclose(
            getattr(tnew, name).numpy(), np.asarray(getattr(jnew, name)),
            err_msg=name, **rows_tol)
    np.testing.assert_allclose(tpos_e.numpy(), np.asarray(jpos_e),
                               **rows_tol)
    np.testing.assert_allclose(tyaw_e.numpy(), np.asarray(jyaw_e),
                               **rows_tol)
    # the mixer and the PWM clip were reached: rpm within the PWM range
    lo, hi = (tpid.PWM2RPM_SCALE * p + tpid.PWM2RPM_CONST
              for p in (tpid.MIN_PWM, tpid.MAX_PWM))
    assert float(trpm.min()) >= lo - 0.01 and float(trpm.max()) <= hi + 0.01


def test_defaults_and_from_state_match_jax():
    """Optional setpoints default to zero; the 20-value state vector is
    sliced as the reference slices it."""
    jm, tm = models("cf2x")
    (pos, quat, vel, tp, _, _, _), pid = _tick_inputs(np.float64)
    vec = np.concatenate([pos, quat, np.zeros((B, 3)), vel,
                          np.zeros((B, 7))], axis=-1)
    jrpm = jpid.compute_control_from_state(
        jm, jpid.PIDState(*(jnp.asarray(a) for a in pid)), 1 / 48,
        jnp.asarray(vec), jnp.asarray(tp))[0]
    t = torch.from_numpy
    trpm = tpid.compute_control_from_state(
        tm, tpid.PIDState(*(t(a) for a in pid)), 1 / 48, t(vec), t(tp))[0]
    np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), rtol=1e-9)


def test_closed_loop_matches_jax_and_golden():
    """30 ticks at 48 Hz over 5 DYN substeps each, float64, from the golden
    file's start: rpm to 1e-6 relative, positions to 1e-6 absolute
    (tests/test_golden.py's tolerance)."""
    data = np.load(GOLDEN)
    jm, tm = models("cf2x")
    target = data["target"]
    start = (np.array([0.0, 0.0, 0.1]), np.array([0.0, 0.0, 0.0, 1.0]),
             np.zeros(3), np.zeros(3), np.zeros(3))
    jst = JDynState(*(jnp.asarray(a) for a in start))
    tst = TDynState(*(torch.from_numpy(a) for a in start))
    jctl = jpid.init_state((), jnp.float64)
    tctl = tpid.init_state((), torch.float64, device="cpu")
    assert all(leaf.shape == (3,) and not leaf.any() for leaf in tctl)
    # one compile each for the 30 ticks and their 150 substeps
    j_control = jax.jit(lambda ctl, pos, quat, vel, target: jpid
                        .compute_control(jm, ctl, 1 / 48, pos, quat, vel,
                                         target))
    j_substep = jax.jit(lambda st, rpm: j_dyn_step(jm, st, rpm, 1 / 240))
    log = np.zeros((30, 7))
    for t in range(30):
        jrpm, jctl, _, _ = j_control(jctl, jst.pos, jst.quat, jst.vel,
                                     jnp.asarray(target))
        trpm, tctl, _, _ = tpid.compute_control(
            tm, tctl, 1 / 48, tst.pos, tst.quat, tst.vel,
            torch.from_numpy(target))
        for _ in range(5):
            jst = j_substep(jst, jrpm)
            tst = t_dyn_step(tm, tst, trpm, 1 / 240)
        log[t] = np.concatenate([trpm.numpy(), tst.pos.numpy()])
        np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), rtol=1e-9)
        np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                                   atol=1e-12)
    np.testing.assert_allclose(log[:, :4], data["log"][:30, :4], rtol=1e-6)
    np.testing.assert_allclose(log[:, 4:], data["log"][:30, 4:], atol=1e-6)


@pytest.mark.parametrize("dim", [1, 2, 4])
def test_one23d_interface_matches_jax(dim):
    jm, tm = models("cf2x")
    thrust = np.random.default_rng(dim).uniform(0.05, 0.6, size=(5, dim))
    ref = np.asarray(jpid.one23d_interface(jm, jnp.asarray(thrust)))
    out = tpid.one23d_interface(tm, torch.from_numpy(thrust))
    assert out.shape == (5, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12)


def test_wrapper_matches_jax_wrapper():
    """The stateful reference-style class, three ticks with overridden
    position gains."""
    jc = jpid.DSLPIDControl()
    tc = tpid.DSLPIDControl(DroneModel.CF2X)
    for c in (jc, tc):
        c.setPIDCoefficients(p_coeff_pos=[0.5, 0.5, 1.5])
    state = np.zeros(20)
    state[2], state[6] = 0.5, 1.0
    for t in range(3):
        state[10:13] = [0.01 * t, 0.0, 0.02 * t]
        jrpm, jpe, jye = jc.computeControlFromState(
            1 / 48, state, target_pos=np.array([0.2, -0.1, 0.8]))
        trpm, tpe, tye = tc.computeControlFromState(
            1 / 48, state, target_pos=np.array([0.2, -0.1, 0.8]))
        np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), rtol=1e-9)
        np.testing.assert_allclose(tpe.numpy(), np.asarray(jpe), rtol=1e-12)
        np.testing.assert_allclose(float(tye), float(jye), atol=1e-12)
    assert tc.control_counter == jc.control_counter == 3
    tc.reset()
    assert tc.control_counter == 0 and not tc.state.integral_pos_e.any()
    with pytest.raises(ValueError):
        tpid.DSLPIDControl(DroneModel.RACE)


def test_init_state_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpid.init_state((4,))
