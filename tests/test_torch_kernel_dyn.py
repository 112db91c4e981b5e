"""The plain PyTorch version of the `dyn_ctrl_step` kernel against the JAX
package's Pallas kernel in interpret mode (as tests/test_pallas.py runs it
on the CPU), and the wrapper's input checks.  On the CPU the wrapper runs
the plain version; the CUDA kernel is held against the same plain version
on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_pybullet_drones_tpu.ops import pallas_dyn
from gym_pybullet_drones_tpu.ops.dynamics import DynState as JDynState
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState as TDynState

from tests._torch_helpers import ATOL, models, rand_dyn, rand_rpm

B = 128
DT = 1 / 240
FIELDS = ("pos", "quat", "vel", "rpy_rates", "ang_v")


def _xla_substeps(jm, leaves, rpm, n):
    """n `dyn_step`s of the JAX package (the XLA path) from float32 leaves."""
    from gym_pybullet_drones_tpu.ops.dynamics import dyn_step
    ref = JDynState(*(jnp.asarray(a, jnp.float32) for a in leaves))
    for _ in range(n):
        ref = dyn_step(jm, ref, jnp.asarray(rpm, jnp.float32), DT)
    return ref


@pytest.mark.parametrize("emit_obs12", [False, True])
def test_plain_dyn_ctrl_step_matches_pallas_interpret(emit_obs12):
    """The state leaves against the Pallas kernel in interpret mode; the
    obs12 block against the XLA path (eight `dyn_step`s, then
    `ops/quat.quat_to_rpy`): interpret mode runs the Pallas kernel's own
    polynomial atan some fifteen times slower.  The Pallas kernel's Euler
    extraction is held to `quat_to_rpy` by the next test."""
    jm, tm = models("cf2x")
    leaves = rand_dyn(B, seed=0)
    rpm = rand_rpm(jm.hover_rpm, B, seed=1)
    jout = pallas_dyn.dyn_ctrl_step(
        jm, JDynState(*(jnp.asarray(a, jnp.float32) for a in leaves)), 8, DT,
        jnp.asarray(rpm, jnp.float32))
    before = kernel_dyn.launches
    tout = kernel_dyn.dyn_ctrl_step(
        tm, TDynState(*(torch.from_numpy(a) for a in leaves)), 8, DT,
        torch.from_numpy(rpm), emit_obs12)
    assert kernel_dyn.launches == before     # a CPU tensor launches nothing
    if emit_obs12:
        from gym_pybullet_drones_tpu.ops.quat import quat_to_rpy
        tout, tobs = tout
        assert tobs.shape == (B, 12)
        ref = _xla_substeps(jm, leaves, rpm, 8)
        jobs = np.concatenate([np.asarray(ref.pos),
                               np.asarray(quat_to_rpy(ref.quat)),
                               np.asarray(ref.vel), np.asarray(ref.ang_v)],
                              axis=-1)
        np.testing.assert_allclose(tobs.numpy(), jobs, rtol=0, atol=ATOL)
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
            rtol=0, atol=ATOL, err_msg=name)
    # column 0 has zero rates and equal rpms: the quaternion is kept bitwise
    np.testing.assert_array_equal(tout.quat.numpy()[0], leaves[1][0])


def test_pallas_rpy_rows_match_quat_to_rpy():
    """The Pallas kernel's obs12 Euler angles (`pallas_math.quat_rpy_rows`,
    the polynomial atan on un-normalized quaternion rows) against the XLA
    path's `quat_to_rpy`, so that the port's obs12, held to the XLA path
    above, is held to the TPU kernel's too.  Random rotations of norm 0.9 to
    1.1, float32; tolerance as for obs12 (rtol 0, atol 2e-5)."""
    from gym_pybullet_drones_tpu.ops import pallas_math
    from gym_pybullet_drones_tpu.ops.quat import quat_to_rpy
    rng = np.random.default_rng(21)
    q = rng.normal(size=(512, 4))
    q *= rng.uniform(0.9, 1.1, size=(512, 1)) / np.linalg.norm(
        q, axis=-1, keepdims=True)
    q = jnp.asarray(q, jnp.float32)
    rows = pallas_math.quat_rpy_rows(*q.T)
    assert all(r.dtype == jnp.float32 for r in rows)
    np.testing.assert_allclose(np.stack([np.asarray(r) for r in rows], -1),
                               np.asarray(quat_to_rpy(q)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_substeps", [1, 5])
def test_plain_dyn_ctrl_step_at_other_substep_counts(n_substeps):
    """1 substep (240 Hz control) and 5, against as many `dyn_step`s of the
    JAX package; tolerance as at 8 substeps."""
    jm, tm = models("cf2x")
    leaves = rand_dyn(16, seed=13)
    rpm = rand_rpm(jm.hover_rpm, 16, seed=14)
    ref = _xla_substeps(jm, leaves, rpm, n_substeps)
    out = kernel_dyn.dyn_ctrl_step(
        tm, TDynState(*(torch.from_numpy(a) for a in leaves)), n_substeps,
        DT, torch.from_numpy(rpm))
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=2e-5, atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(out.quat.numpy()[0], leaves[1][0])


@pytest.mark.parametrize("model", ["cf2p", "racer"])
def test_plain_dyn_ctrl_step_matches_xla_substeps(model):
    """The model-dependent torque composition (CF2P arms, RACE z-sign),
    against eight `dyn_step`s of the JAX package."""
    jm, tm = models(model)
    leaves = rand_dyn(16, seed=11)
    rpm = rand_rpm(jm.hover_rpm, 16, seed=12)
    ref = _xla_substeps(jm, leaves, rpm, 8)
    out = kernel_dyn.dyn_ctrl_step(
        tm, TDynState(*(torch.from_numpy(a) for a in leaves)), 8, DT,
        torch.from_numpy(rpm))
    for name in FIELDS:
        np.testing.assert_allclose(
            getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=2e-5, atol=ATOL, err_msg=name)


def test_pack_unpack_round_trip():
    st = TDynState(*(torch.from_numpy(a) for a in rand_dyn(5, seed=2)))
    packed = kernel_dyn._pack(st)
    assert packed.shape == (16, 5) and packed.is_contiguous()
    back = kernel_dyn._unpack(packed, st)
    for a, b in zip(st, back):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["dtype", "rows", "contiguous", "width",
                                 "substeps"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad):
    _, tm = models("cf2x")
    s = torch.zeros((16, 8))
    s[6] = 1.0
    r = torch.full((4, 8), tm.hover_rpm, dtype=torch.float32)
    n = 8
    if bad == "dtype":
        s = s.double()
    elif bad == "rows":
        s = s[:13].contiguous()
    elif bad == "contiguous":
        s = torch.zeros((8, 16)).t()
    elif bad == "width":
        r = r[:, :4].contiguous()
    else:
        n = 0
    with pytest.raises((TypeError, ValueError)):
        kernel_dyn.dyn_ctrl_step_rows(tm, s, r, n, DT)
