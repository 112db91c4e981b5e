"""Explicit quadrotor rigid-body dynamics (the DYN physics mode).

Counterpart of the JAX package's `ops/dynamics.py`: the explicit integrator
of the reference engine (BaseAviary.py:815-889, `_dynamics` + `_integrateQ`)
with its arithmetic order,

    thrust_world = R @ [0, 0, sum(kf * rpm^2)]
    force_world  = thrust_world - [0, 0, g*m]
    torques      = mixer(kf*rpm^2, km*rpm^2) - w x (J w)   (w ~ rpy_rates)
    vel       += dt * force_world / m           (explicit)
    rpy_rates += dt * J^-1 torques              (explicit)
    pos       += dt * vel                       (semi-implicit in position)
    quat       = exp-map integration of (quat, new rpy_rates)
    ang_v_world (stored) = R_old @ rpy_rates_new

as a pure function over tensors with arbitrary leading batch dimensions.
Scalar parameters enter as Python floats and so keep the working dtype
(float32 for throughput, float64 for the parity harness).  This is the
general-dtype path; the float32 rollout runs `ops/kernel_dyn.py`.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.params import DroneParams
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops


class DynState(NamedTuple):
    """Carried state of the explicit integrator (leading dims broadcast)."""

    pos: torch.Tensor        # (..., 3) world position
    quat: torch.Tensor       # (..., 4) xyzw orientation
    vel: torch.Tensor        # (..., 3) world linear velocity
    rpy_rates: torch.Tensor  # (..., 3) body roll/pitch/yaw rates (DYN carry)
    ang_v: torch.Tensor      # (..., 3) world angular velocity (stored only)


def motor_forces_torques(params: DroneParams, rpm: torch.Tensor):
    """Per-motor thrusts and the aggregate body torques.

    Mixer parity: reference BaseAviary.py:838-852 (incl. the RACE z-torque
    negation at :843-845 and the CF2X/CF2P arm geometry split at :846-851).

    Two formulations, selected by dtype:

    - float64 (the parity-oracle path): left-to-right sums in the
      reference's NumPy arithmetic order.
    - float32 (the production path): each mixer component is a sum of
      FACTORED squared-rpm differences, e.g.
      ``x = ((r0-r2)(r0+r2) + (r1-r3)(r1+r3)) * (kf*arm)``.  The naive
      ``(f0+f1-f2-f3)*arm`` form is algebraically identical, but a compiler
      that contracts ``kf*rpm^2`` into FMAs rounds the "same" thrust
      differently per use, and the cancellation of equal thrusts leaves
      ~1e-10 torque residuals that the attitude dynamics amplify.  The
      factored form cancels exactly for bitwise-equal rpms under ANY
      contraction scheme (a-a == 0 is exact).
    """
    forces = rpm * rpm * params.kf                     # (..., 4)
    z_torques = rpm * rpm * params.km
    if params.model == DroneModel.RACE:
        z_torques = -z_torques
    if rpm.dtype == torch.float64:
        f0, f1, f2, f3 = (forces[..., i] for i in range(4))
        t0, t1, t2, t3 = (z_torques[..., i] for i in range(4))
        z_torque = -t0 + t1 - t2 + t3
        if params.model == DroneModel.CF2P:
            x_torque = (f1 - f3) * params.l
            y_torque = (-f0 + f2) * params.l
        else:  # CF2X and RACE
            arm = params.l / math.sqrt(2)
            x_torque = (f0 + f1 - f2 - f3) * arm
            y_torque = (-f0 + f1 + f2 - f3) * arm
    else:
        r0, r1, r2, r3 = (rpm[..., i] for i in range(4))
        dsq = lambda a, b: (a - b) * (a + b)           # a^2 - b^2, exact at a==b
        km_s = -params.km if params.model == DroneModel.RACE else params.km
        z_torque = (dsq(r1, r0) + dsq(r3, r2)) * km_s
        if params.model == DroneModel.CF2P:
            x_torque = dsq(r1, r3) * (params.kf * params.l)
            y_torque = dsq(r2, r0) * (params.kf * params.l)
        else:  # CF2X and RACE
            karm = params.kf * params.l / math.sqrt(2)
            x_torque = (dsq(r0, r2) + dsq(r1, r3)) * karm
            y_torque = (dsq(r1, r0) + dsq(r2, r3)) * karm
    torques = torch.stack([x_torque, y_torque, z_torque], dim=-1)
    return forces, torques


def dyn_step(params: DroneParams, state: DynState, rpm: torch.Tensor,
             dt: float) -> DynState:
    """One explicit-dynamics substep at the physics rate (PYB_TIMESTEP).

    Pure-function equivalent of reference BaseAviary._dynamics
    (BaseAviary.py:815-874) over batched state.
    """
    rotation = quat_ops.quat_to_mat(state.quat)        # (..., 3, 3)
    forces, torques = motor_forces_torques(params, rpm)
    total_thrust = torch.sum(forces, dim=-1)           # (...,)
    # R @ [0,0,T] == T * R[:, 2] exactly (zero columns drop out bitwise)
    thrust_world = rotation[..., :, 2] * total_thrust[..., None]
    gravity_vec = torch.zeros_like(thrust_world)
    gravity_vec[..., 2] = params.gravity
    force_world = thrust_world - gravity_vec

    # Euler's equation: tau -= w x (J w), J diagonal (BaseAviary.py:853)
    w = state.rpy_rates
    j_diag = torch.tensor([params.ixx, params.iyy, params.izz],
                          dtype=w.dtype, device=w.device)
    torques = torques - torch.linalg.cross(w, j_diag * w)
    # Multiply by the precomputed reciprocal diagonal (not a division): the
    # reference uses np.dot(J_INV, torques) with J_INV = inv(diag(J)).
    j_inv_diag = torch.tensor(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz],
        dtype=w.dtype, device=w.device)
    rpy_rates_deriv = torques * j_inv_diag

    acc = force_world / params.m
    vel = state.vel + dt * acc
    rpy_rates = w + dt * rpy_rates_deriv
    pos = state.pos + dt * vel
    new_quat = quat_ops.integrate_quat(state.quat, rpy_rates, dt)
    # Stored world angular velocity uses the PRE-step rotation (reference
    # BaseAviary.py:868-872 reuses `rotation` computed from the old quat).
    ang_v = torch.einsum("...ij,...j->...i", rotation, rpy_rates)
    return DynState(pos=pos, quat=new_quat, vel=vel, rpy_rates=rpy_rates,
                    ang_v=ang_v)
