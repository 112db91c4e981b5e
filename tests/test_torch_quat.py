"""Port ops/quat.py against the JAX package's, element by element."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_pybullet_drones_tpu.ops import quat as jq
from gym_pybullet_drones_tpu_torch.ops import quat as tq

TOL = {np.float64: 1e-12, np.float32: 1e-6}
B = 64


def _inputs(dtype):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    rpy = rng.uniform(-1.2, 1.2, size=(B, 3))
    omega = rng.normal(size=(B, 3)) * 3
    omega[0] = 0.0                      # the keep branch
    return (np.asarray(q, dtype), np.asarray(rpy, dtype),
            np.asarray(omega, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", ["quat_to_mat", "rpy_to_quat", "quat_to_rpy",
                                "integrate_quat", "mat_to_euler_xyz",
                                "euler_xyz_to_quat"])
def test_quat_matches_jax(fn, dtype):
    q, rpy, omega = _inputs(dtype)
    mat = np.array(jq.quat_to_mat(jnp.asarray(q)))
    args = {"quat_to_mat": (q,), "rpy_to_quat": (rpy,), "quat_to_rpy": (q,),
            "integrate_quat": (q, omega), "mat_to_euler_xyz": (mat,),
            "euler_xyz_to_quat": (rpy,)}[fn]
    extra = (1 / 240,) if fn == "integrate_quat" else ()
    ref = np.asarray(getattr(jq, fn)(*(jnp.asarray(a) for a in args), *extra))
    out = getattr(tq, fn)(*(torch.from_numpy(a) for a in args), *extra)
    assert out.numpy().dtype == dtype and ref.dtype == dtype
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype])
    if fn == "integrate_quat":
        np.testing.assert_array_equal(out.numpy()[0], q[0])


def test_rpy_round_trip():
    _, rpy, _ = _inputs(np.float64)
    back = tq.quat_to_rpy(tq.rpy_to_quat(torch.from_numpy(rpy)))
    np.testing.assert_allclose(back.numpy(), rpy, atol=1e-12)


def test_euler_xyz_round_trip_and_clip():
    """Intrinsic-XYZ angles -> quaternion -> matrix -> the same angles; an
    entry of 1 + 1 ulp, which a normalisation can leave, gives pi/2 and not
    NaN."""
    _, e, _ = _inputs(np.float64)
    m = tq.quat_to_mat(tq.euler_xyz_to_quat(torch.from_numpy(e)))
    np.testing.assert_allclose(tq.mat_to_euler_xyz(m).numpy(), e, atol=1e-12)
    over = torch.eye(3, dtype=torch.float32)
    over[0, 2] = float(np.nextafter(np.float32(1), np.float32(2)))
    b = tq.mat_to_euler_xyz(over)[1]
    assert torch.isfinite(b) and abs(float(b) - np.pi / 2) < 1e-6


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("fn", ["quat_mul", "quat_conj", "rotate_vector",
                                "integrate_quat_world"])
def test_pyb_quat_additions_match_jax(fn, dtype):
    """What the PYB physics added: Hamilton product, conjugate, vector
    rotation, and the world-frame exponential map with its keep branch."""
    q, rpy, omega = _inputs(dtype)
    q2 = np.roll(q, 1, axis=0)
    args = {"quat_mul": (q, q2), "quat_conj": (q,),
            "rotate_vector": (omega, q),
            "integrate_quat_world": (q, omega)}[fn]
    extra = (1 / 240,) if fn == "integrate_quat_world" else ()
    ref = np.asarray(getattr(jq, fn)(*(jnp.asarray(a) for a in args), *extra))
    out = getattr(tq, fn)(*(torch.from_numpy(a) for a in args), *extra)
    assert out.numpy().dtype == dtype and ref.dtype == dtype
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=3 * TOL[dtype])
    if fn == "integrate_quat_world":
        np.testing.assert_array_equal(out.numpy()[0], q[0])


def test_rotate_vector_is_the_matrix_and_world_map_is_a_left_product():
    q, _, omega = (torch.from_numpy(a) for a in _inputs(np.float64))
    by_matrix = torch.einsum("bij,bj->bi", tq.quat_to_mat(q), omega)
    np.testing.assert_allclose(tq.rotate_vector(omega, q).numpy(),
                               by_matrix.numpy(), atol=1e-12)
    # a world-frame rate integrates as exp(w dt) (x) q: rotating the body
    # rate into the world gives the body-rate integrator's answer
    dt = 1 / 240
    world = tq.integrate_quat_world(q, by_matrix, dt)
    body = tq.integrate_quat(q, omega, dt)
    np.testing.assert_allclose(world.numpy(), body.numpy(), atol=1e-12)
    unit = tq.quat_mul(q, tq.quat_conj(q))
    np.testing.assert_allclose(
        unit.numpy(), np.tile([0.0, 0, 0, 1], (B, 1)), atol=1e-12)
