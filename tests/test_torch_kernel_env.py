"""`ops/kernel_env.env_ctrl_step` (on the CPU: its plain rows) against the
JAX package: the XLA path that `pallas_env.env_ctrl_step` is equivalent to
(`core._apply_physics_substep` composed over the substeps, after the
embedded DSL-PID where there is one), every PYB mode and DYN, and once the
Pallas kernel itself in interpret mode; and the plain rows against the
port's own tensor modules for every mode, N = 1 and 2, with and without the
PID preamble.

The plain rows keep the TPU kernel's arithmetic order (R (J^-1 (R^T v)),
unordered pairs), the XLA path and the port's tensor modules the other one,
so the tolerance is the JAX package's own between its two paths
(tests/test_pallas.py:241-259): 3e-4 relative / 5e-4 absolute, 1e-3 with the
PID (:292).  Two substeps at 120 Hz control, as there: they cover the stale
drag and the contact-after-integrate order.  Drones spawn STACKED: at one
height the downwash sits on its dz > 0 tie."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.control import dsl_pid as jpid
from gym_pybullet_drones_tpu.envs import core as jcore
from gym_pybullet_drones_tpu.envs.tasks import CtrlTask as JCtrl
from gym_pybullet_drones_tpu.ops import pallas_env
from gym_pybullet_drones_tpu.ops.dynamics import DynState as JDynState
from gym_pybullet_drones_tpu.utils import enums as JE
from gym_pybullet_drones_tpu import params as JP

from gym_pybullet_drones_tpu_torch import params as TP
from gym_pybullet_drones_tpu_torch.control import dsl_pid as tpid
from gym_pybullet_drones_tpu_torch.envs import core as tcore
from gym_pybullet_drones_tpu_torch.envs.tasks import CtrlTask as TCtrl
from gym_pybullet_drones_tpu_torch.ops import kernel_env
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState as TDynState
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import rand_pid

MODES = ("pyb", "pyb_gnd", "pyb_drag", "pyb_dw", "pyb_gnd_drag_dw", "dyn")
OBSTACLES = ((0.3, 0.0, 0.25, 0.1), (-0.3, 0.0, 0.2, 0.1, 0.1, 0.1))
B, SUB, DT, CDT = 4, 2, 1 / 240, 1 / 120
TOL = dict(rtol=3e-4, atol=5e-4)
PID_TOL = dict(rtol=1e-3, atol=1e-3)


def _state(n, seed):
    """Seeded (B*N, k) float32 leaves.  Env 0: drones on the ground; env 1:
    drone 0 against the sphere; env 2: drone 0 inside the box's contact
    window; env 3: a pair in contact (n = 2).  Drone 1 flies 0.25-0.4 m
    over drone 0 (stacked: downwash acts, no dz tie)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((B, n, 3))
    pos[:, 0] = [[0.0, 0.0, 0.02], [0.14, 0.0, 0.25], [-0.3, 0.17, 0.2],
                 [0.0, 0.5, 0.5]]
    if n == 2:
        pos[:, 1] = pos[:, 0] + [[0.1, 0.0, 0.25], [0.02, 0.0, 0.4],
                                 [0.0, 0.03, 0.35], [0.03, 0.0, 0.1]]
    rpy = rng.uniform(-0.2, 0.2, size=(B, n, 3))
    vel = rng.normal(size=(B, n, 3)) * 0.2
    vel[3, 0] = [0.0, 0.0, 0.3]                # closing on the drone above
    rates = rng.normal(size=(B, n, 3))
    ang_v = rng.normal(size=(B, n, 3))
    from gym_pybullet_drones_tpu.ops import quat as jq
    quat = np.array(jq.rpy_to_quat(jnp.asarray(rpy)))
    f = lambda a: np.ascontiguousarray(
        a.reshape(B * n, -1).astype(np.float32))
    return tuple(f(a) for a in (pos, quat, vel, rates, ang_v))


def _cfgs(mode, n):
    kw = dict(num_drones=n, pyb_freq=240, ctrl_freq=120,
              obstacles=OBSTACLES)
    return (jcore.AviaryConfig(drone=JP.CF2X, physics=JE.Physics(mode), **kw),
            tcore.AviaryConfig(drone=TP.CF2X, physics=TE.Physics(mode), **kw))


def _jax_xla(jcfg, leaves, rpm, last_rpm):
    """The XLA equivalent of `pallas_env.env_ctrl_step`: the substeps of
    `core._apply_physics_substep` on (B, N, k) leaves under vmap."""
    n = jcfg.num_drones
    s1, _, _ = jcore.reset(jcfg, JCtrl())
    r3 = lambda a: jnp.asarray(a).reshape(B, n, -1)
    st = jax.tree.map(lambda x: jnp.stack([x] * B), s1)._replace(
        pos=r3(leaves[0]), quat=r3(leaves[1]), vel=r3(leaves[2]),
        rpy_rates=r3(leaves[3]), ang_v=r3(leaves[4]), last_rpm=r3(last_rpm))

    def sub(s, r):
        for _ in range(SUB):
            s = jcore._apply_physics_substep(jcfg, s, r)
        return s
    out = jax.jit(jax.vmap(sub))(st, r3(rpm))
    return [np.asarray(x).reshape(B * n, -1) for x in
            (out.pos, out.quat, out.vel, out.rpy_rates, out.ang_v)]


def _torch_tensor_path(tcfg, leaves, rpm, last_rpm):
    """The port's own tensor modules, leading batch dims written out."""
    n = tcfg.num_drones
    s1, _, _ = tcore.reset(tcfg, TCtrl(), device="cpu")
    r3 = lambda a: torch.from_numpy(a).reshape(B, n, -1)
    st = tcore.map_leaves(lambda x: torch.stack([x] * B), s1)._replace(
        pos=r3(leaves[0]), quat=r3(leaves[1]), vel=r3(leaves[2]),
        rpy_rates=r3(leaves[3]), ang_v=r3(leaves[4]), last_rpm=r3(last_rpm))
    for _ in range(SUB):
        st = tcore._apply_physics_substep(tcfg, st, r3(rpm))
    return [x.reshape(B * n, -1).numpy() for x in
            (st.pos, st.quat, st.vel, st.rpy_rates, st.ang_v)]


def _port(tcfg, leaves, action, last_rpm, pid=None, emit_obs12=False,
          sub=SUB):
    state = TDynState(*(torch.from_numpy(a) for a in leaves))
    ctrl = None if pid is None else tpid.PIDState(
        *(torch.from_numpy(a) for a in pid))
    return kernel_env.env_ctrl_step(
        None if pid is None else TP.CF2X, tcfg.drone, tcfg.physics,
        tcfg.num_drones, sub, DT, CDT, tcfg.obstacles, state, ctrl,
        torch.from_numpy(action), torch.from_numpy(last_rpm), emit_obs12)


def _rpms(n, seed):
    rng = np.random.default_rng(seed)
    mk = lambda: (TP.CF2X.hover_rpm * (
        1 + 0.05 * rng.normal(size=(B * n, 4)))).astype(np.float32)
    return mk(), mk()


def _check(got, ref, tol, what):
    for k, g, r in zip(("pos", "quat", "vel", "rpy_rates", "ang_v"),
                       got, ref):
        np.testing.assert_allclose(np.asarray(g), r, err_msg=f"{what} {k}",
                                   **tol)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_env_ctrl_step_matches_jax_xla(mode, n):
    """RPM actions: every physics mode, ground, sphere, box and pair
    contact, stacked downwash, the stale drag of substep 0."""
    jcfg, tcfg = _cfgs(mode, n)
    leaves = _state(n, 1)
    rpm, last = _rpms(n, 2)
    ref = _jax_xla(jcfg, leaves, rpm, last)
    out, ctrl, rpm_out, obs12 = _port(tcfg, leaves, rpm, last,
                                      emit_obs12=True)
    assert ctrl is None and out.pos.dtype == torch.float32
    _check(out, ref, TOL, f"{mode} n={n}")
    np.testing.assert_array_equal(rpm_out.numpy(), rpm)
    # obs12 = pos, rpy, vel, world ang-vel of the stepped state
    from gym_pybullet_drones_tpu_torch.ops import quat as tq
    np.testing.assert_allclose(
        obs12.numpy(), torch.cat([out.pos, tq.quat_to_rpy(out.quat),
                                  out.vel, out.ang_v], dim=-1).numpy(),
        atol=1e-6)
    if mode == "dyn":
        assert not np.array_equal(out.rpy_rates.numpy(), leaves[3])
    else:
        # rpy_rates pass through the PYB step; the physics did act
        np.testing.assert_array_equal(out.rpy_rates.numpy(), leaves[3])
        assert np.abs(out.vel.numpy() - leaves[2]).max() > 1e-2


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("use_pid", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plain_rows_match_the_tensor_modules(mode, use_pid, n):
    """The kernel's arithmetic order against `ops/rigid_body.py` +
    `ops/aero.py` (+ `control/dsl_pid.py`) composed by `envs/core.py`."""
    _, tcfg = _cfgs(mode, n)
    leaves = _state(n, 3)
    rpm, last = _rpms(n, 4)
    pid = action = None
    if use_pid:
        rng = np.random.default_rng(5)
        pid = rand_pid(B * n, 6)
        tgt = np.zeros((B * n, 12), np.float32)
        tgt[:, 0:3] = leaves[0] + 0.2 * rng.normal(size=(B * n, 3))
        tgt[:, 5] = 0.3 * rng.normal(size=B * n)
        tgt[:, 6:9] = 0.1 * rng.normal(size=(B * n, 3))
        action = tgt
        t = torch.from_numpy
        rpm_t, new_pid, _, _ = tpid.compute_control(
            TP.CF2X, tpid.PIDState(*(t(a) for a in pid)), CDT,
            cur_pos=t(leaves[0]), cur_quat=t(leaves[1]),
            cur_vel=t(leaves[2]), target_pos=t(tgt[:, 0:3]),
            target_rpy=t(tgt[:, 3:6]), target_vel=t(tgt[:, 6:9]))
        rpm = rpm_t.numpy()
    ref = _torch_tensor_path(tcfg, leaves, rpm, last)
    out, ctrl, rpm_out, *_ = _port(tcfg, leaves, rpm if action is None
                                   else action, last, pid)
    tol = PID_TOL if use_pid else TOL
    _check(out, ref, tol, f"{mode} n={n} pid={use_pid}")
    if use_pid:
        np.testing.assert_allclose(rpm_out.numpy(), rpm, rtol=2e-5, atol=0.5)
        for k in tpid.PIDState._fields:
            np.testing.assert_allclose(getattr(ctrl, k).numpy(),
                                       getattr(new_pid, k).numpy(),
                                       rtol=3e-4, atol=2e-5, err_msg=k)


def test_env_ctrl_step_with_pid_matches_jax_xla():
    """The PID preamble on PYB physics: the JAX package's `compute_control`
    then its XLA substeps (1e-3, tests/test_pallas.py:292)."""
    jcfg, tcfg = _cfgs("pyb", 2)
    leaves = _state(2, 7)
    _, last = _rpms(2, 8)
    pid = rand_pid(B * 2, 9)
    rng = np.random.default_rng(10)
    tgt = np.zeros((B * 2, 12), np.float32)
    tgt[:, 0:3] = leaves[0] + 0.2 * rng.normal(size=(B * 2, 3))
    tgt[:, 5] = 0.3 * rng.normal(size=B * 2)
    j = jnp.asarray
    jrpm, jnew, _, _ = jpid.compute_control(
        JP.CF2X, jpid.PIDState(*(j(a) for a in pid)), CDT,
        cur_pos=j(leaves[0]), cur_quat=j(leaves[1]), cur_vel=j(leaves[2]),
        target_pos=j(tgt[:, 0:3]), target_rpy=j(tgt[:, 3:6]),
        target_vel=j(tgt[:, 6:9]))
    ref = _jax_xla(jcfg, leaves, np.asarray(jrpm), last)
    out, ctrl, rpm_out, obs12 = _port(tcfg, leaves, tgt, last, pid, True)
    _check(out, ref, PID_TOL, "pyb pid")
    np.testing.assert_allclose(rpm_out.numpy(), np.asarray(jrpm), rtol=2e-5,
                               atol=0.5)
    for k in tpid.PIDState._fields:
        np.testing.assert_allclose(getattr(ctrl, k).numpy(),
                                   np.asarray(getattr(jnew, k)), rtol=3e-4,
                                   atol=2e-5, err_msg=k)
    assert obs12.shape == (B * 2, 12)


def test_env_ctrl_step_matches_pallas_interpret():
    """The TPU kernel itself under interpretation, every aero effect, a
    stacked pair, B = 2 (its own arithmetic order: tighter than the XLA
    comparison, 2e-5 / 1e-4; the ang-vel rows, which contact impulses reach
    through 1/J, 5e-4 / 3e-4).  One substep: the interpreted kernel
    unrolls its substeps, and its compile, which is this test's time,
    grows with them; the XLA comparisons above hold the two-substep order
    (stale drag, contact after the integration)."""
    n, b = 2, 2
    jcfg, tcfg = _cfgs("pyb_gnd_drag_dw", n)
    leaves = [a[:b * n] for a in _state(n, 11)]
    rpm, last = (a[:b * n] for a in _rpms(n, 12))
    jstate = JDynState(*(jnp.asarray(a) for a in leaves))
    jout, _, jrpm, jobs = pallas_env.env_ctrl_step(
        None, jcfg.drone, jcfg.physics, n, 1, DT, CDT, jcfg.obstacles,
        jstate, None, jnp.asarray(rpm), jnp.asarray(last), True)
    out, _, rpm_out, obs12 = _port(tcfg, leaves, rpm, last, emit_obs12=True,
                                   sub=1)
    for k in ("pos", "quat", "vel", "rpy_rates"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   np.asarray(getattr(jout, k)), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    np.testing.assert_allclose(out.ang_v.numpy(), np.asarray(jout.ang_v),
                               rtol=3e-4, atol=5e-4)
    np.testing.assert_allclose(obs12.numpy()[:, :9], np.asarray(jobs)[:, :9],
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(rpm_out.numpy(), np.asarray(jrpm))


@pytest.mark.parametrize("sweeps", [1, 50])
def test_any_sweep_count(sweeps):
    """`solver_iterations` is a run-time value of the kernel: the wrapper
    takes what `core.step` takes, here against the port's tensor modules."""
    import dataclasses
    _, tcfg = _cfgs("pyb", 1)
    tcfg = dataclasses.replace(tcfg, solver_iterations=sweeps)
    leaves = _state(1, 13)
    rpm, last = _rpms(1, 14)
    ref = _torch_tensor_path(tcfg, leaves, rpm, last)
    state = TDynState(*(torch.from_numpy(a) for a in leaves))
    out, _, _ = kernel_env.env_ctrl_step(
        None, tcfg.drone, tcfg.physics, 1, SUB, DT, CDT, tcfg.obstacles,
        state, None, torch.from_numpy(rpm), torch.from_numpy(last),
        solver_iterations=sweeps)
    _check(out, ref, TOL, f"sweeps={sweeps}")


def test_rows_entry_and_what_the_wrapper_refuses():
    """The rows-level entry: column e*N + d holds drone d of env e; shapes,
    types and capacities the kernel does not take raise on the CPU too."""
    n = 2
    _, tcfg = _cfgs("pyb_drag", n)
    leaves = _state(n, 15)
    rpm, last = _rpms(n, 16)
    rows = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))
    s = rows(np.concatenate(leaves, axis=-1))
    args = (None, tcfg.drone, tcfg.physics, n, SUB, DT, CDT, tcfg.obstacles)
    out, rpm_out, pid_out, obs12 = kernel_env.env_ctrl_step_rows(
        *args, s, rows(rpm), None, rows(last))
    assert out.shape == (16, B * n) and pid_out is None and obs12 is None
    via = _port(tcfg, leaves, rpm, last)[0]
    np.testing.assert_array_equal(out[0:3].t().numpy(), via.pos.numpy())
    assert kernel_env.launches == 0            # no card, no launch
    for bad in (lambda: kernel_env.env_ctrl_step_rows(
                    *args, s.double(), rows(rpm), None, rows(last)),
                lambda: kernel_env.env_ctrl_step_rows(
                    *args, s, rows(rpm)[:3], None, rows(last)),
                lambda: kernel_env.env_ctrl_step_rows(
                    *args, s, rows(rpm), None, None),          # drag mode
                lambda: kernel_env.env_ctrl_step_rows(
                    *args, s[:, :5].contiguous(), rows(rpm)[:, :5]
                    .contiguous(), None, rows(last)[:, :5].contiguous()),
                lambda: kernel_env.env_ctrl_step_rows(
                    *args[:7], ((0.0, 0.0, 1.0, 0.1),) * 9, s, rows(rpm),
                    None, rows(last)),
                lambda: kernel_env.env_ctrl_step_rows(
                    *args[:3], 9, *args[4:], s, rows(rpm), None,
                    rows(last))):
        with pytest.raises((TypeError, ValueError)):
            bad()
