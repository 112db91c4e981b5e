"""Aerodynamic effect models: ground effect, rotor drag, downwash.

Counterpart of the JAX package's `ops/aero.py`; formulas of the reference
engine (BaseAviary.py:715-811):

- ground effect (:715-750): per-prop heights via forward kinematics, clipped
  below at GND_EFF_H_CLIP; upward per-prop force
  kf*rpm^2 * gnd_eff_coeff * (prop_radius / (4 h))^2, gated on
  |roll|, |pitch| < pi/2, applied in the LINK frame (i.e. rotated by R).
- drag (:754-781): body-frame force R^T (-drag_coeff * sum(2 pi rpm / 60) * v),
  applied at the CoM in the LINK frame; the caller must pass the PREVIOUS
  control step's clipped rpm (reference step() passes last_clipped_action,
  BaseAviary.py:359,366).
- downwash (:785-811): for every drone i above drone n (dz > 0, dxy < 10 m),
  alpha = dw1 (prop_radius / (4 dz))^2, beta = dw2 dz + dw3,
  force [0, 0, -alpha exp(-0.5 (dxy/beta)^2)] in the LINK frame.

States are shaped (..., N, 3) / (..., N, 4) with the leading batch
dimensions written out; downwash is a masked O(N^2) pairwise reduction over
the trailing drone axis.  General dtype: float64 for the parity harness,
float32 for the tensor path (the float32 rollout runs the same formulas
inside `ops/kernel_env.py`'s kernel).

Each function returns (world_force, world_torque) increments about the CoM.
"""
from __future__ import annotations

import math

import torch

from gym_pybullet_drones_tpu_torch.params import DroneParams


def _offsets(params: DroneParams, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(params.prop_offsets, dtype=like.dtype,
                        device=like.device)                       # (4, 3)


def prop_positions(params: DroneParams, pos: torch.Tensor,
                   rot: torch.Tensor) -> torch.Tensor:
    """World positions of the 4 prop links: pos + R @ offset.

    Analytic replacement of the reference's p.getLinkStates forward
    kinematics (BaseAviary.py:732-737).
    Shapes: pos (..., 3), rot (..., 3, 3) -> (..., 4, 3).
    """
    world_off = torch.einsum("...ij,pj->...pi", rot, _offsets(params, pos))
    return pos[..., None, :] + world_off


def ground_effect(params: DroneParams, rpm: torch.Tensor, pos: torch.Tensor,
                  rot: torch.Tensor, rpy: torch.Tensor):
    """Ground-effect force/torque about the CoM (world frame).

    Per-prop LINK-frame force [0,0,G_i] => world force R @ [0,0,G_i] applied
    at prop position, contributing torque (R @ offset_i) x (R @ [0,0,G_i]).
    """
    world_off = torch.einsum("...ij,pj->...pi", rot,
                             _offsets(params, pos))               # (..., 4, 3)
    heights = pos[..., None, 2] + world_off[..., 2]               # (..., 4)
    heights = torch.clamp(heights, min=params.gnd_eff_h_clip)
    gnd = (rpm * rpm) * params.kf * params.gnd_eff_coeff * \
        (params.prop_radius / (4.0 * heights)) ** 2               # (..., 4)
    # Whole-drone attitude gate (BaseAviary.py:742)
    upright = (torch.abs(rpy[..., 0]) < math.pi / 2) & \
              (torch.abs(rpy[..., 1]) < math.pi / 2)
    gnd = gnd * upright[..., None].to(pos.dtype)
    # world force per prop = G_i * R[:, 2]
    z_axis = rot[..., :, 2]                                       # (..., 3)
    force = torch.sum(gnd, dim=-1)[..., None] * z_axis
    f_per_prop = gnd[..., None] * z_axis[..., None, :]            # (..., 4, 3)
    torque = torch.sum(torch.linalg.cross(world_off, f_per_prop), dim=-2)
    return force, torque


def drag(params: DroneParams, last_rpm: torch.Tensor, vel: torch.Tensor,
         rot: torch.Tensor):
    """Rotor drag force about the CoM (world frame), zero torque.

    Reference computes body drag = R^T (-c * sum(omega_rot) * v) and applies
    it in the LINK frame, so the net world force is R @ R^T (-c * ...) — kept
    in this composed form for behavioral parity.
    """
    coeff = torch.tensor(params.drag_coeff, dtype=vel.dtype,
                         device=vel.device)
    omega_sum = torch.sum(2 * math.pi * last_rpm / 60.0, dim=-1)  # (...,)
    drag_world_pre = -coeff * omega_sum[..., None] * vel          # (..., 3)
    drag_body = torch.einsum("...ji,...j->...i", rot, drag_world_pre)
    force = torch.einsum("...ij,...j->...i", rot, drag_body)
    return force, torch.zeros_like(force)


def downwash(params: DroneParams, pos: torch.Tensor, rot: torch.Tensor):
    """Pairwise downwash forces (world frame), zero torque.

    pos: (..., N, 3) over a trailing drone axis.  For receiver n, every drone
    i with dz = z_i - z_n > 0 and horizontal distance dxy < 10 m contributes a
    LINK-frame force [0, 0, -alpha exp(-0.5 (dxy/beta)^2)] => world force
    along -R_n[:, 2].  Drones at ONE height have dz = 0 and no downwash; a
    last-bit difference there switches a very large alpha on or off, so
    callers that compare two implementations spawn the drones stacked.
    """
    z = pos[..., 2]                                               # (..., N)
    dz = z[..., None, :] - z[..., :, None]                        # [n, i]
    dxy_vec = pos[..., None, :, :2] - pos[..., :, None, :2]       # (..n,i,2)
    dxy = torch.linalg.norm(dxy_vec, dim=-1)                      # (..., n, i)
    mask = (dz > 0) & (dxy < 10.0)
    safe_dz = torch.where(mask, dz, 1.0)
    alpha = params.dw_coeff_1 * (params.prop_radius / (4.0 * safe_dz)) ** 2
    beta = params.dw_coeff_2 * safe_dz + params.dw_coeff_3
    mag = alpha * torch.exp(-0.5 * (dxy / beta) ** 2)             # (..., n, i)
    total = torch.sum(torch.where(mask, mag, 0.0), dim=-1)        # (..., n)
    z_axis = rot[..., :, 2]                                       # (..., n, 3)
    force = -total[..., None].to(pos.dtype) * z_axis
    return force, torch.zeros_like(force)
