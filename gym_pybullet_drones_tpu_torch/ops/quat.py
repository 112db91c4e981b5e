"""Batched quaternion / rotation math on torch tensors.

Counterpart of the JAX package's `ops/quat.py`: what the DYN rollout
path and the DSL-PID controller need, and the Hamilton product, vector
rotation and world-frame integrator of the PYB physics.

Conventions:
- Quaternions are `xyzw` (PyBullet's layout), stored in the last axis.
- "rpy" means roll-pitch-yaw about fixed world axes, i.e. R = Rz(y)Ry(p)Rx(r)
  — PyBullet's Euler convention.
- "euler_xyz" means intrinsic XYZ Euler angles (scipy's 'XYZ'), which the
  DSL-PID controller uses.

All functions broadcast over arbitrary leading batch dimensions and keep
the dtype and device of their input.
"""
from __future__ import annotations

import torch


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> (..., 3, 3) rotation matrix.

    Matches PyBullet's getMatrixFromQuaternion (which normalizes internally).
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def rpy_to_quat(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (fixed-axis XYZ) -> xyzw quaternion.

    Matches PyBullet's getQuaternionFromEuler.
    """
    r, p, y = rpy[..., 0] * 0.5, rpy[..., 1] * 0.5, rpy[..., 2] * 0.5
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_to_rpy(q: torch.Tensor) -> torch.Tensor:
    """xyzw quaternion -> roll-pitch-yaw (fixed-axis XYZ).

    Matches PyBullet's getEulerFromQuaternion (Bullet btMatrix3x3::getEulerZYX).
    """
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinp = torch.clamp(2 * (w * y - z * x), -1.0, 1.0)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def mat_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> intrinsic-XYZ Euler angles (a, b, c).

    Matches scipy Rotation.from_matrix(m).as_euler('XYZ') away from gimbal
    lock: R = Rx(a) @ Ry(b) @ Rz(c), so b = asin(R[0,2]),
    a = atan2(-R[1,2], R[2,2]), c = atan2(-R[0,1], R[0,0]).
    """
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def euler_xyz_to_quat(e: torch.Tensor) -> torch.Tensor:
    """Intrinsic-XYZ Euler angles -> xyzw quaternion.

    Matches scipy Rotation.from_euler('XYZ', e).as_quat():
    q = qx(a) * qy(b) * qz(c) with Hamilton product.
    """
    a, b, c = e[..., 0] * 0.5, e[..., 1] * 0.5, e[..., 2] * 0.5
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    # Hamilton product qx * qy * qz expanded:
    w = ca * cb * cc - sa * sb * sc
    x = sa * cb * cc + ca * sb * sc
    y = ca * sb * cc - sa * cb * sc
    z = ca * cb * sc + sa * sb * cc
    return torch.stack([x, y, z, w], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of xyzw quaternions (rotation q1 followed-by-local
    q2)."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of an xyzw quaternion."""
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def rotate_vector(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by xyzw quaternion(s) q (active rotation)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def integrate_quat(q: torch.Tensor, omega: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """Exact exponential-map quaternion integration with BODY rates.

    Parity target: reference BaseAviary._integrateQ (BaseAviary.py:876-889):
        q' = (cos(theta) I + (2/||w||) sin(theta) Lambda) q,
    theta = ||w|| dt / 2, returning q unchanged when ||w|| <= 1e-8
    (np.isclose's default atol).  The matrix-vector rows are expanded with
    the reference's multiply/add order so float64 results track it.
    """
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    omega_norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
    theta = omega_norm * dt / 2
    cos_t = torch.cos(theta)
    # s = (2/||w||) sin(theta) * 0.5  -- the .5 from Lambda's definition
    safe_norm = torch.where(omega_norm > 0, omega_norm,
                            torch.ones_like(omega_norm))
    s = 2.0 / safe_norm * torch.sin(theta) * 0.5
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    nx = cos_t * x + s * (wz * y - wy * z + wx * w)
    ny = cos_t * y + s * (-wz * x + wx * z + wy * w)
    nz = cos_t * z + s * (wy * x - wx * y + wz * w)
    nw = cos_t * w + s * (-wx * x - wy * y - wz * z)
    new_q = torch.stack([nx, ny, nz, nw], dim=-1)
    keep = (omega_norm <= 1e-8)[..., None]
    return torch.where(keep, q, new_q)


def integrate_quat_world(q: torch.Tensor, omega_world: torch.Tensor,
                         dt: float) -> torch.Tensor:
    """Exponential-map integration with a WORLD-frame angular velocity.

    q' = exp(omega_world * dt) (x) q  (left Hamilton product), the update
    Bullet's integrator applies to base orientations.  `integrate_quat`
    above is the BODY-rate (right-multiply) variant used by the explicit
    DYN mode.
    """
    norm = torch.linalg.norm(omega_world, dim=-1, keepdim=True)
    theta = norm * dt / 2
    safe = torch.where(norm > 0, norm, 1.0)
    axis = omega_world / safe
    rot = torch.cat([torch.sin(theta) * axis, torch.cos(theta)], dim=-1)
    out = quat_mul(rot, q)
    return torch.where(norm <= 1e-8, q, out)
