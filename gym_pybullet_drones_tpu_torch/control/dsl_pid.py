"""DSL cascaded PID controller (Crazyflie) as a pure, batchable function.

Counterpart of the JAX package's `control/dsl_pid.py`.  Behavioral parity
target: the reference control/DSLPIDControl.py — gains and constants from
:37-60, position loop from :149-208, attitude loop from :212-259.
Controller scratch (`last_rpy`, `integral_pos_e`, `integral_rpy_e`;
reference :65-78) is an explicit carried NamedTuple instead of object
attributes, so one call advances the controllers of a whole batch of
drones (the reference keeps one Python object per drone,
BaseRLAviary.py:73-78).

The gains and PWM constants below are this package's own copy; the CUDA
device function `gpd_pid_tick` (csrc/drone_kernels.cuh) and its plain row
version `ops/kernel_pid.pid_tick_rows` repeat them.

Note on the reference's euler->quat->matrix round-trip (:242-244): it unpacks
scipy's xyzw as_quat() into variables named (w, x, y, z) and feeds the SAME
list back to from_quat — the permutation is a no-op, so the target rotation
is simply R(target_euler); this implementation computes it directly.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.params import DroneParams, G, get_params
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.graphs import constant
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops

# Gains and PWM constants (reference DSLPIDControl.py:37-46)
P_FOR = (0.4, 0.4, 1.25)
I_FOR = (0.05, 0.05, 0.05)
D_FOR = (0.2, 0.2, 0.5)
P_TOR = (70000.0, 70000.0, 60000.0)
I_TOR = (0.0, 0.0, 500.0)
D_TOR = (20000.0, 20000.0, 12000.0)
PWM2RPM_SCALE = 0.2685
PWM2RPM_CONST = 4070.3
MIN_PWM = 20000.0
MAX_PWM = 65535.0

# Motor mixers (reference DSLPIDControl.py:47-60)
MIXER_CF2X = (
    (-0.5, -0.5, -1.0),
    (-0.5, 0.5, 1.0),
    (0.5, 0.5, -1.0),
    (0.5, -0.5, 1.0),
)
MIXER_CF2P = (
    (0.0, -1.0, -1.0),
    (1.0, 0.0, 1.0),
    (0.0, 1.0, -1.0),
    (-1.0, 0.0, 1.0),
)


def mixer_of(params: DroneParams):
    """The 4x3 PWM mixer of a controller's drone model."""
    return MIXER_CF2P if params.model == DroneModel.CF2P else MIXER_CF2X


class PIDState(NamedTuple):
    """Carried controller scratch, broadcastable over (..., 3) leading dims."""

    last_rpy: torch.Tensor         # (..., 3)
    integral_pos_e: torch.Tensor   # (..., 3)
    integral_rpy_e: torch.Tensor   # (..., 3)


def init_state(batch_shape: tuple[int, ...] = (), dtype=torch.float32,
               device=None) -> PIDState:
    """Zero controller state (reference DSLPIDControl.reset, :65-78).
    `device=None` is the CUDA card, as everywhere in the package."""
    device = resolve_device(device)
    z = lambda: torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                            device=device)
    return PIDState(last_rpy=z(), integral_pos_e=z(), integral_rpy_e=z())


def _at_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b over the last two axes, as an elementwise sum (no BLAS call:
    the result does not depend on a library's matmul mode)."""
    return (a[..., :, :, None] * b[..., :, None, :]).sum(dim=-3)


def compute_control(params: DroneParams, state: PIDState, dt: float,
                    cur_pos: torch.Tensor, cur_quat: torch.Tensor,
                    cur_vel: torch.Tensor, target_pos: torch.Tensor,
                    target_rpy: torch.Tensor | None = None,
                    target_vel: torch.Tensor | None = None,
                    target_rpy_rates: torch.Tensor | None = None,
                    gains: dict | None = None, g: float = G):
    """One PID tick: state + setpoints -> (rpm, new_state, pos_e, yaw_e).

    All tensor arguments broadcast over leading batch dims.  `cur_ang_vel` of
    the reference signature is unused there (DSLPIDControl.py:96) and dropped.
    """
    if target_rpy is None:
        target_rpy = torch.zeros_like(cur_pos)
    if target_vel is None:
        target_vel = torch.zeros_like(cur_vel)
    if target_rpy_rates is None:
        target_rpy_rates = torch.zeros_like(cur_pos)

    gains = gains or {}
    vec = lambda key, default: constant(
        default if gains.get(key) is None else tuple(gains[key]),
        cur_pos.dtype, cur_pos.device)
    p_for, i_for, d_for = (vec("p_for", P_FOR), vec("i_for", I_FOR),
                           vec("d_for", D_FOR))
    p_tor, i_tor, d_tor = (vec("p_tor", P_TOR), vec("i_tor", I_TOR),
                           vec("d_tor", D_TOR))
    gravity = g * params.m  # reference BaseControl.py:36-41 (g * URDF mass)
    cur_rotation = quat_ops.quat_to_mat(cur_quat)              # (..., 3, 3)

    # ---- Position loop (reference :149-208) ----
    pos_e = target_pos - cur_pos
    vel_e = target_vel - cur_vel
    integral_pos_e = torch.clamp(state.integral_pos_e + pos_e * dt, -2.0, 2.0)
    integral_pos_e = torch.cat(
        [integral_pos_e[..., :2],
         torch.clamp(integral_pos_e[..., 2:], -0.15, 0.15)], dim=-1)
    target_thrust = p_for * pos_e + i_for * integral_pos_e + d_for * vel_e
    target_thrust = torch.cat(
        [target_thrust[..., :2], target_thrust[..., 2:] + gravity], dim=-1)
    scalar_thrust = torch.clamp(
        torch.sum(target_thrust * cur_rotation[..., :, 2], dim=-1), min=0.0)
    thrust = (torch.sqrt(scalar_thrust / (4 * params.kf))
              - PWM2RPM_CONST) / PWM2RPM_SCALE                 # (...,)
    target_z_ax = target_thrust / torch.linalg.norm(
        target_thrust, dim=-1, keepdim=True)
    yaw = target_rpy[..., 2]
    target_x_c = torch.stack(
        [torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    target_z_ax, target_x_c = torch.broadcast_tensors(target_z_ax, target_x_c)
    zxc = torch.linalg.cross(target_z_ax, target_x_c, dim=-1)
    target_y_ax = zxc / torch.linalg.norm(zxc, dim=-1, keepdim=True)
    target_x_ax = torch.linalg.cross(target_y_ax, target_z_ax, dim=-1)
    # columns are the target axes
    target_rotation = torch.stack(
        [target_x_ax, target_y_ax, target_z_ax], dim=-1)      # (..., 3, 3)
    target_euler = quat_ops.mat_to_euler_xyz(target_rotation)

    # ---- Attitude loop (reference :212-259) ----
    cur_rpy = quat_ops.quat_to_rpy(cur_quat)
    # R(target_euler) via the euler->quat->matrix round-trip (see module doc)
    target_rotation_att = quat_ops.quat_to_mat(
        quat_ops.euler_xyz_to_quat(target_euler))
    rot_matrix_e = (_at_b(target_rotation_att, cur_rotation)
                    - _at_b(cur_rotation, target_rotation_att))
    rot_e = torch.stack(
        [rot_matrix_e[..., 2, 1], rot_matrix_e[..., 0, 2],
         rot_matrix_e[..., 1, 0]], dim=-1)
    rpy_rates_e = target_rpy_rates - (cur_rpy - state.last_rpy) / dt
    integral_rpy_e = torch.clamp(state.integral_rpy_e - rot_e * dt,
                                 -1500.0, 1500.0)
    integral_rpy_e = torch.cat(
        [torch.clamp(integral_rpy_e[..., :2], -1.0, 1.0),
         integral_rpy_e[..., 2:]], dim=-1)
    target_torques = torch.clamp(
        -p_tor * rot_e + d_tor * rpy_rates_e + i_tor * integral_rpy_e,
        -3200.0, 3200.0)
    mixer = constant(mixer_of(params), cur_pos.dtype,
                     cur_pos.device)                           # (4, 3)
    pwm = thrust[..., None] + torch.sum(
        mixer * target_torques[..., None, :], dim=-1)
    pwm = torch.clamp(pwm, MIN_PWM, MAX_PWM)
    rpm = PWM2RPM_SCALE * pwm + PWM2RPM_CONST

    new_state = PIDState(last_rpy=cur_rpy, integral_pos_e=integral_pos_e,
                         integral_rpy_e=integral_rpy_e)
    yaw_e = target_euler[..., 2] - cur_rpy[..., 2]
    return rpm, new_state, pos_e, yaw_e


def compute_control_from_state(params: DroneParams, state: PIDState,
                               dt: float, drone_state: torch.Tensor,
                               target_pos: torch.Tensor,
                               target_rpy: torch.Tensor | None = None,
                               target_vel: torch.Tensor | None = None,
                               target_rpy_rates: torch.Tensor | None = None):
    """Slice the 20-dim state vector (reference BaseControl.py:55-93)."""
    return compute_control(
        params, state, dt,
        cur_pos=drone_state[..., 0:3],
        cur_quat=drone_state[..., 3:7],
        cur_vel=drone_state[..., 10:13],
        target_pos=target_pos, target_rpy=target_rpy, target_vel=target_vel,
        target_rpy_rates=target_rpy_rates)


def one23d_interface(params: DroneParams,
                     thrust: torch.Tensor) -> torch.Tensor:
    """1/2/4-dim thrust input -> 4 PWMs (reference DSLPIDControl.py:263-287)."""
    thrust = torch.atleast_1d(thrust)
    dim = thrust.shape[-1]
    pwm = torch.clamp(
        (torch.sqrt(thrust / (params.kf * (4 / dim))) - PWM2RPM_CONST)
        / PWM2RPM_SCALE, MIN_PWM, MAX_PWM)
    if dim in (1, 4):
        return pwm.repeat_interleave(4 // dim, dim=-1)
    if dim == 2:
        return torch.cat([pwm, torch.flip(pwm, dims=(-1,))], dim=-1)
    raise ValueError("thrust input must have length 1, 2, or 4")


class DSLPIDControl:
    """Stateful convenience wrapper mirroring the reference class API.

    Holds a PIDState and exposes computeControl / computeControlFromState /
    reset with the reference's signatures (DSLPIDControl.py:19-145) for
    drop-in use in example scripts; the functional core above is what the
    batched env paths use.  A host-side, one-drone object: it lives on the
    CPU unless given another device.
    """

    def __init__(self, drone_model: DroneModel = DroneModel.CF2X,
                 g: float = 9.8, dtype=torch.float64, device="cpu"):
        if drone_model not in (DroneModel.CF2X, DroneModel.CF2P):
            raise ValueError(
                "DSLPIDControl requires DroneModel.CF2X or DroneModel.CF2P")
        self.params = get_params(drone_model)
        self.g = float(g)
        self.dtype = dtype
        self.device = torch.device(device)
        self.control_counter = 0
        self._gains = {}
        self.reset()

    def reset(self):
        self.control_counter = 0
        self.state = init_state((), self.dtype, self.device)

    def setPIDCoefficients(self, p_coeff_pos=None, i_coeff_pos=None,
                           d_coeff_pos=None, p_coeff_att=None,
                           i_coeff_att=None, d_coeff_att=None):
        """Override gains (reference BaseControl.setPIDCoefficients:138-177).

        Sets instance-level gain overrides consumed by computeControl via
        the functional core's gain arguments.
        """
        arr = lambda x: None if x is None else np.asarray(x, float).tolist()
        self._gains = {
            "p_for": arr(p_coeff_pos), "i_for": arr(i_coeff_pos),
            "d_for": arr(d_coeff_pos), "p_tor": arr(p_coeff_att),
            "i_tor": arr(i_coeff_att), "d_tor": arr(d_coeff_att),
        }

    def computeControl(self, control_timestep, cur_pos, cur_quat, cur_vel,
                       cur_ang_vel=None, target_pos=None,
                       target_rpy=None, target_vel=None,
                       target_rpy_rates=None):
        self.control_counter += 1
        as_t = lambda x: None if x is None else torch.as_tensor(
            np.asarray(x), dtype=self.dtype, device=self.device)
        rpm, self.state, pos_e, yaw_e = compute_control(
            self.params, self.state, float(control_timestep),
            as_t(cur_pos), as_t(cur_quat), as_t(cur_vel),
            as_t(target_pos), as_t(target_rpy), as_t(target_vel),
            as_t(target_rpy_rates), gains=self._gains, g=self.g)
        return rpm, pos_e, yaw_e

    def computeControlFromState(self, control_timestep, state, target_pos,
                                target_rpy=None, target_vel=None,
                                target_rpy_rates=None):
        state = np.asarray(state)
        return self.computeControl(
            control_timestep,
            cur_pos=state[0:3], cur_quat=state[3:7], cur_vel=state[10:13],
            cur_ang_vel=state[13:16], target_pos=target_pos,
            target_rpy=target_rpy, target_vel=target_vel,
            target_rpy_rates=target_rpy_rates)
