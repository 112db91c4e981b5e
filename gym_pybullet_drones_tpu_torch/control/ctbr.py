"""Collective-thrust / body-rates controller (for Betaflight-style SITL).

Counterpart of the JAX package's `control/ctbr.py`.  Parity target:
reference gym_pybullet_drones/control/CTBRControl.py:103-168 — PD position
loop (K_P=[3,3,8], K_D=[2.5,2.5,5]), quaternion-error body-rate law
(K_RATES=[5,5,1]), returning (normalized_thrust, p, q, r) instead of motor
RPMs.  The reference computes in transforms3d's wxyz quaternion
convention; the functional core here takes the native xyzw and is
algebraically identical.
"""
from __future__ import annotations

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops

K_P = (3.0, 3.0, 8.0)
K_D = (2.5, 2.5, 5.0)
K_RATES = (5.0, 5.0, 1.0)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _mat_to_quat_xyzw(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> xyzw quaternion (branch-free Shepperd variant)."""
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2
    qx = torch.sqrt(torch.clamp(
        1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2], min=0.0)) / 2
    qy = torch.sqrt(torch.clamp(
        1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2], min=0.0)) / 2
    qz = torch.sqrt(torch.clamp(
        1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2], min=0.0)) / 2
    qx = torch.copysign(qx, m[..., 2, 1] - m[..., 1, 2])
    qy = torch.copysign(qy, m[..., 0, 2] - m[..., 2, 0])
    qz = torch.copysign(qz, m[..., 1, 0] - m[..., 0, 1])
    return _unit(torch.stack([qx, qy, qz, qw], dim=-1))


def compute_ctbr(cur_pos, cur_quat, cur_vel, target_pos, target_vel=None):
    """(thrust, body_rates): collective thrust + body-rate commands.

    cur_quat is xyzw.  Broadcasts over leading batch dims.
    """
    if target_vel is None:
        target_vel = torch.zeros_like(cur_vel)
    as_vec = lambda v: torch.tensor(v, dtype=cur_pos.dtype,
                                    device=cur_pos.device)
    g = as_vec([0.0, 0.0, -9.8])

    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    tar_acc = as_vec(K_P) * pos_e + as_vec(K_D) * vel_e - g
    z_world = torch.zeros_like(cur_pos)
    z_world[..., 2] = 1.0
    body_z = quat_ops.rotate_vector(z_world, cur_quat)
    norm_thrust = (tar_acc * body_z).sum(dim=-1)

    # target attitude from desired acceleration direction
    z_body = _unit(tar_acc)
    y_axis = torch.zeros_like(cur_pos)
    y_axis[..., 1] = 1.0
    y_axis, z_body_b = torch.broadcast_tensors(y_axis, z_body)
    x_body = _unit(torch.linalg.cross(y_axis, z_body_b))
    y_body = _unit(torch.linalg.cross(z_body_b, x_body))
    tar_rot = torch.stack([x_body, y_body, z_body_b], dim=-1)  # columns
    tar_att = _mat_to_quat_xyzw(tar_rot)

    # quaternion error in the body frame; shortest-rotation sign fix
    q_err = quat_ops.quat_mul(quat_ops.quat_conj(cur_quat), tar_att)
    rates = 2.0 * as_vec(K_RATES) * q_err[..., :3]
    rates = torch.where(q_err[..., 3:4] < 0, -rates, rates)
    return norm_thrust, rates


class CTBRControl:
    """Class wrapper with the reference's API (control/CTBRControl.py).

    computeControlFromState slices the 20-dim state vector, whose xyzw
    quaternion is the same rotation as the reference's wxyz.  A host-side,
    one-drone object, as `DSLPIDControl`: it computes in float64 on the
    CPU unless given another dtype or device.
    """

    def __init__(self, drone_model=None, g: float = 9.8,
                 dtype=torch.float64, device="cpu"):
        self.DRONE_MODEL = drone_model
        self.dtype = dtype
        self.device = torch.device(device)

    def reset(self):
        pass

    def computeControlFromState(self, control_timestep, state, target_pos,
                                target_rpy=None, target_vel=None,
                                target_rpy_rates=None):
        state = np.asarray(state)
        return self.computeControl(
            control_timestep, cur_pos=state[0:3], cur_quat=state[3:7],
            cur_vel=state[10:13], cur_ang_vel=state[13:16],
            target_pos=target_pos, target_vel=target_vel)

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel=None, target_pos=None, target_rpy=None,
                       target_vel=None, target_rpy_rates=None):
        as_t = lambda x: None if x is None else torch.as_tensor(
            np.asarray(x), dtype=self.dtype, device=self.device)
        thrust, rates = compute_ctbr(as_t(cur_pos), as_t(cur_quat),
                                     as_t(cur_vel), as_t(target_pos),
                                     as_t(target_vel))
        r = rates.cpu().numpy()
        return float(thrust), float(r[0]), float(r[1]), float(r[2])
