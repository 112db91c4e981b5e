"""Crazyflie firmware-grade components as torch functions.

Counterpart of the JAX package's `control/firmware.py`: the pycffirmware
surface the reference CFAviary consumes (reference
envs/CFAviary.py:127-180,293-301,368-420,613-652): the 2-pole low-pass
sensor filters (`lpf2p*`), the Mellinger trajectory-tracking controller
(`controllerMellinger`), the brushed motor PWM curve and X-formation
power distribution.  Algorithms follow the published crazyflie-firmware
sources (filter.c, controller_mellinger.c, power_distribution_stock.c), as
pure functions with explicit state.  The arithmetic is the JAX package's,
operation for operation, so that the two agree tick for tick in float64.

The firmware is a host-side loop of one drone at 500-1000 Hz: its tensors
are (3,)-vectors that live wherever the caller puts them (`CFAviary` keeps
them on the CPU, in the aviary's dtype).

Units follow the firmware conventions: sensor gyro in deg/s, accelerometer
in g, state attitude in degrees (with the legacy inverted pitch), thrust in
the 16-bit PWM-scale units of control_t.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.control.dsl_pid import _at_b
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops

RAD2DEG = 180.0 / math.pi
DEG2RAD = math.pi / 180.0
GRAVITY_MAGNITUDE = 9.81
VEHICLE_MASS = 0.032
MASS_THRUST = 132000.0

# Mellinger gains (controller_mellinger.c defaults)
KP_XY, KD_XY, KI_XY, I_RANGE_XY = 0.4, 0.2, 0.05, 2.0
KP_Z, KD_Z, KI_Z, I_RANGE_Z = 1.25, 0.4, 0.05, 0.4
KR_XY, KW_XY, KI_M_XY, I_RANGE_M_XY = 70000.0, 20000.0, 0.0, 1.0
KR_Z, KW_Z, KI_M_Z, I_RANGE_M_Z = 60000.0, 12000.0, 500.0, 1500.0
KD_OMEGA_RP = 200.0

MIN_PWM, MAX_PWM = 20000.0, 65535.0
SUPPLY_VOLTAGE = 3.0


# ---------------------------------------------------------------------------
# 2-pole Butterworth low-pass (firmware filter.c lpf2pInit/lpf2pApply)
# ---------------------------------------------------------------------------
class Lpf2pState(NamedTuple):
    d1: torch.Tensor
    d2: torch.Tensor


def lpf2p_coeffs(sample_freq: float, cutoff_freq: float):
    """Biquad coefficients, matching firmware lpf2pSetCutoffFreq."""
    fr = sample_freq / cutoff_freq
    ohm = math.tan(math.pi / fr)
    c = 1.0 + 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm
    b0 = ohm * ohm / c
    b1 = 2.0 * b0
    b2 = b0
    a1 = 2.0 * (ohm * ohm - 1.0) / c
    a2 = (1.0 - 2.0 * math.cos(math.pi / 4.0) * ohm + ohm * ohm) / c
    return b0, b1, b2, a1, a2


def lpf2p_init(shape=(), dtype=torch.float32, device="cpu") -> Lpf2pState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return Lpf2pState(d1=z, d2=z)


def lpf2p_apply(coeffs, state: Lpf2pState, sample: torch.Tensor):
    """Direct-form-II application; returns (filtered, new_state)."""
    b0, b1, b2, a1, a2 = coeffs
    d0 = sample - state.d1 * a1 - state.d2 * a2
    out = d0 * b0 + state.d1 * b1 + state.d2 * b2
    return out, Lpf2pState(d1=d0, d2=state.d1)


# ---------------------------------------------------------------------------
# Setpoint / control structures (firmware stabilizer_types.h equivalents)
# ---------------------------------------------------------------------------
class Setpoint(NamedTuple):
    """Subset of setpoint_t used by the Mellinger controller.

    position/velocity/acceleration in m-based units, attitude_rate in deg/s,
    quat xyzw.
    """

    position: torch.Tensor       # (3,)
    velocity: torch.Tensor       # (3,)
    acceleration: torch.Tensor   # (3,)
    attitude_rate: torch.Tensor  # (3,) deg/s (roll, pitch, yaw)
    quat: torch.Tensor           # (4,) xyzw desired attitude


class FirmwareState(NamedTuple):
    """Carried Mellinger controller scratch (integrals + gyro memory)."""

    i_error_pos: torch.Tensor    # (3,) position integral
    i_error_m: torch.Tensor      # (3,) attitude-moment integral
    prev_omega: torch.Tensor     # (2,) previous roll/pitch gyro (rad/s)


def firmware_init(dtype=torch.float32, device="cpu") -> FirmwareState:
    z = lambda n: torch.zeros(n, dtype=dtype, device=device)
    return FirmwareState(i_error_pos=z(3), i_error_m=z(3), prev_omega=z(2))


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def mellinger_control(state: FirmwareState, setpoint: Setpoint,
                      pos, vel, quat, gyro_deg, dt: float):
    """One Mellinger tick -> (control(thrust, roll, pitch, yaw), new_state).

    pos/vel: world m, m/s; quat: state attitude xyzw; gyro_deg: deg/s body.
    Output units match control_t (16-bit thrust scale, moment counts).
    """
    r_error = setpoint.position - pos
    v_error = setpoint.velocity - vel
    i_pos = state.i_error_pos + r_error * dt
    i_pos = torch.clamp(
        i_pos, _vec([-I_RANGE_XY, -I_RANGE_XY, -I_RANGE_Z], pos),
        _vec([I_RANGE_XY, I_RANGE_XY, I_RANGE_Z], pos))

    kp = _vec([KP_XY, KP_XY, KP_Z], pos)
    kd = _vec([KD_XY, KD_XY, KD_Z], pos)
    ki = _vec([KI_XY, KI_XY, KI_Z], pos)
    gravity_comp = _vec([0.0, 0.0, GRAVITY_MAGNITUDE], pos)
    target_thrust = (VEHICLE_MASS * (setpoint.acceleration + gravity_comp)
                     + kp * r_error + kd * v_error + ki * i_pos)

    # desired yaw from the setpoint quaternion (modeAbs quat path)
    desired_yaw = quat_ops.quat_to_rpy(setpoint.quat)[..., 2]

    R = quat_ops.quat_to_mat(quat)
    z_axis = R[..., :, 2]
    current_thrust = (target_thrust * z_axis).sum(dim=-1)
    z_des = _normalize(target_thrust)
    x_c = torch.stack([torch.cos(desired_yaw), torch.sin(desired_yaw),
                       torch.zeros_like(desired_yaw)], dim=-1)
    y_des = _normalize(torch.linalg.cross(z_des, x_c))
    x_des = torch.linalg.cross(y_des, z_des)
    R_des = torch.stack([x_des, y_des, z_des], dim=-1)

    eRM = _at_b(R_des, R) - _at_b(R, R_des)
    # vee with the firmware's legacy pitch sign flip
    eR = torch.stack([eRM[..., 2, 1], -eRM[..., 0, 2], eRM[..., 1, 0]],
                     dim=-1) * 0.5

    gyro_rad = gyro_deg * DEG2RAD
    sp_rate_rad = setpoint.attitude_rate * DEG2RAD
    # pitch uses the legacy inverted convention end-to-end (matching the
    # eR.y sign flip above and the power-distribution mixing): its rate
    # error is (gyro - setpoint) where roll/yaw use (setpoint - gyro).
    ew = torch.stack([
        sp_rate_rad[..., 0] - gyro_rad[..., 0],
        gyro_rad[..., 1] - sp_rate_rad[..., 1],
        sp_rate_rad[..., 2] - gyro_rad[..., 2]], dim=-1)

    err_d_roll = -(gyro_rad[..., 0] - state.prev_omega[..., 0]) / dt
    err_d_pitch = (gyro_rad[..., 1] - state.prev_omega[..., 1]) / dt
    prev_omega = torch.stack([gyro_rad[..., 0], gyro_rad[..., 1]], dim=-1)

    i_m = state.i_error_m + (-eR) * dt
    i_m = torch.clamp(
        i_m, _vec([-I_RANGE_M_XY, -I_RANGE_M_XY, -I_RANGE_M_Z], pos),
        _vec([I_RANGE_M_XY, I_RANGE_M_XY, I_RANGE_M_Z], pos))

    mx = (-KR_XY * eR[..., 0] + KW_XY * ew[..., 0]
          + KI_M_XY * i_m[..., 0] + KD_OMEGA_RP * err_d_roll)
    my = (-KR_XY * eR[..., 1] + KW_XY * ew[..., 1]
          + KI_M_XY * i_m[..., 1] + KD_OMEGA_RP * err_d_pitch)
    mz = -KR_Z * eR[..., 2] + KW_Z * ew[..., 2] + KI_M_Z * i_m[..., 2]

    thrust = MASS_THRUST * current_thrust
    active = thrust > 0
    zero = torch.zeros_like(thrust)
    roll = torch.where(active, torch.clamp(mx, -32000, 32000), zero)
    pitch = torch.where(active, torch.clamp(my, -32000, 32000), zero)
    yaw = torch.where(active, torch.clamp(-mz, -32000, 32000), zero)
    # reset integrals when the thrust command is non-positive
    i_pos = torch.where(active[..., None], i_pos, 0.0)
    i_m = torch.where(active[..., None], i_m, 0.0)

    control = torch.stack([thrust, roll, pitch, yaw], dim=-1)
    return control, FirmwareState(i_error_pos=i_pos, i_error_m=i_m,
                                  prev_omega=prev_omega)


# ---------------------------------------------------------------------------
# Power distribution + brushed motor model (reference CFAviary.py:613-652)
# ---------------------------------------------------------------------------
def motors_get_pwm(thrust):
    """Brushed motor thrust->PWM curve (reference CFAviary.py:615-624)."""
    thrust = thrust / 65536.0 * 60.0
    volts = -0.0006239 * thrust * thrust + 0.088 * thrust
    percentage = torch.clamp(volts / SUPPLY_VOLTAGE, max=1.0)
    return percentage * MAX_PWM


def power_distribution(control, quad_formation_x: bool = True):
    """control (thrust, roll, pitch, yaw) -> 4 motor PWMs.

    X-formation mixing per reference CFAviary._powerDistribution (:633-652).
    """
    thrust, roll, pitch, yaw = (control[..., i] for i in range(4))
    if quad_formation_x:
        r = roll / 2.0
        p = pitch / 2.0
        m = torch.stack([thrust - r + p + yaw,
                         thrust - r - p - yaw,
                         thrust + r - p + yaw,
                         thrust + r + p - yaw], dim=-1)
    else:
        m = torch.stack([thrust + pitch + yaw,
                         thrust - roll - yaw,
                         thrust - pitch + yaw,
                         thrust + roll - yaw], dim=-1)
    m = torch.clamp(m, 0.0, MAX_PWM)
    return motors_get_pwm(m)
