"""Port ops/aero.py against the JAX package's, function by function:
float64 at 1e-12 and float32 at 1e-6 (relative to each output's scale), with
the upright gate and the downwash mask on both sides."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_pybullet_drones_tpu.ops import aero as jaero, quat as jq
from gym_pybullet_drones_tpu_torch.ops import aero as taero, quat as tq

from tests._torch_helpers import MODELS, models

TOL = {np.float64: 1e-12, np.float32: 1e-6}
B, N = 6, 3


def _inputs(dtype, hover_rpm):
    """(B, N, ...) states: env 0 near the ground, env 1 rolled and env 2
    pitched past the upright gate, env 3 stacked (downwash on), env 4 side
    by side at one height (downwash masked off: dz = 0 exactly)."""
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(B, N, 3)) * 0.4 + [0, 0, 1.0]
    rpy = rng.uniform(-0.5, 0.5, size=(B, N, 3))
    pos[0, :, 2] = rng.uniform(0.01, 0.08, size=N)
    rpy[1, :, 0] = [1.8, -2.5, 3.0]
    rpy[2, :, 1] = [1.5, -1.55, 1.2]
    rpy[2, :, 0] = [2.0, 0.1, -1.7]
    pos[3] = [[0, 0, 0.4], [0.02, 0.01, 0.7], [-0.03, 0.0, 1.0]]
    pos[4, :, 2] = 0.7
    vel = rng.normal(size=(B, N, 3))
    rpm = hover_rpm * (1 + 0.1 * rng.normal(size=(B, N, 4)))
    quat = np.array(jq.rpy_to_quat(jnp.asarray(rpy)))
    return tuple(np.asarray(a, dtype) for a in (pos, quat, rpy, vel, rpm))


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    assert got.numpy().dtype == dtype and ref.dtype == dtype
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", MODELS)
def test_aero_matches_jax(model, dtype):
    jm, tm = models(model)
    pos, quat, rpy, vel, rpm = _inputs(dtype, jm.hover_rpm)
    jrot = jq.quat_to_mat(jnp.asarray(quat))
    trot = tq.quat_to_mat(torch.from_numpy(quat))
    t = torch.from_numpy
    _close(taero.prop_positions(tm, t(pos), trot),
           jaero.prop_positions(jm, jnp.asarray(pos), jrot), dtype)
    jf, jt = jaero.ground_effect(jm, jnp.asarray(rpm), jnp.asarray(pos),
                                 jrot, jnp.asarray(rpy))
    tf, tt = taero.ground_effect(tm, t(rpm), t(pos), trot, t(rpy))
    _close(tf, jf, dtype)
    _close(tt, jt, dtype)
    # the gate: nothing for a drone past pi/2 in roll or pitch, something
    # for the upright ones near the ground
    gated = (np.abs(rpy[..., 0]) >= np.pi / 2) \
        | (np.abs(rpy[..., 1]) >= np.pi / 2)
    assert gated.sum() >= 4 and not tf.numpy()[gated].any()
    assert (np.abs(tf.numpy()[0]).sum(axis=-1) > 0).all()
    jf, jt = jaero.drag(jm, jnp.asarray(rpm), jnp.asarray(vel), jrot)
    tf, tt = taero.drag(tm, t(rpm), t(vel), trot)
    _close(tf, jf, dtype)
    assert not tt.any() and tt.shape == tf.shape
    jf, jt = jaero.downwash(jm, jnp.asarray(pos), jrot)
    tf, tt = taero.downwash(tm, t(pos), trot)
    _close(tf, jf, dtype)
    assert not tt.any()
    # the mask: the lowest of the stack feels both above it, the top one
    # nothing; at one height (dz = 0) nobody feels anything
    mag = np.linalg.norm(tf.numpy(), axis=-1)
    assert mag[3, 0] > mag[3, 1] > 0 and mag[3, 2] == 0
    assert not mag[4].any()


def test_zero_rpm_gives_zero_ground_effect_and_drag():
    _, tm = models("cf2x")
    pos, quat, rpy, vel, rpm = (torch.from_numpy(a)
                                for a in _inputs(np.float32, 0.0))
    rot = tq.quat_to_mat(quat)
    assert not taero.ground_effect(tm, rpm, pos, rot, rpy)[0].any()
    assert not taero.drag(tm, rpm, vel, rot)[0].any()
