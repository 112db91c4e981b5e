"""Crazyflie firmware `controller_pid` cascade as torch functions.

Counterpart of the JAX package's `control/firmware_pid.py`, the firmware
controller the reference consumes through pycffirmware as
`firm.controllerPid` (reference CFAviary.py:401-416 selects it when
CONTROLLER='pid'; the C sources are controller_pid.c,
attitude_pid_controller.c, position_controller_pid.c of
bitcraze/crazyflie-firmware).  Structure and default gains follow the
2021.06 firmware:

- position loop (100 Hz): position error -> velocity setpoint (P only,
  kp=2.0), velocity error -> attitude setpoint + thrust
  (vx/vy kp=25 ki=1, vz kp=25 ki=15, thrust = raw*1000 + 36000, clamped to
  [20000, 65535], roll/pitch clamped to +-20 deg, world->body yaw rotation
  with the firmware's legacy sign conventions),
- attitude loop (500 Hz): angle PIDs (roll/pitch kp=6 ki=3, yaw kp=6 ki=1
  kd=0.35, yaw error wrapped to +-180 deg) -> body-rate setpoints,
- rate loop (500 Hz): rate PIDs (roll/pitch kp=250 ki=500 kd=2.5,
  yaw kp=120 ki=16.7) -> int16-saturated moment commands; the firmware
  negates the yaw command on output (controller_pid.c).

All angles in degrees, rates in deg/s and positions in meters.  Every PID
keeps (integ, prev_error) in an explicit carried NamedTuple of 0-d
tensors; the arithmetic is the JAX package's, operation for operation.
The firmware's optional D-term LPF is disabled by default in these loops
and is omitted, as there.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

DEG2RAD = math.pi / 180.0
INT16_MAX = 32767.0

# pid.h / attitude_pid_controller.c defaults
ATT_GAINS = {  # angle loops: (kp, ki, kd, integ_limit)
    "roll": (6.0, 3.0, 0.0, 20.0),
    "pitch": (6.0, 3.0, 0.0, 20.0),
    "yaw": (6.0, 1.0, 0.35, 360.0),
}
RATE_GAINS = {  # rate loops
    "roll": (250.0, 500.0, 2.5, 33.3),
    "pitch": (250.0, 500.0, 2.5, 33.3),
    "yaw": (120.0, 16.7, 0.0, 166.7),
}
# position_controller_pid.c defaults
POS_KP = 2.0                      # x/y/z position -> velocity setpoint
VEL_XY = (25.0, 1.0, 0.0, 5000.0)  # kp, ki, kd, iLimit (PID_VEL_*)
VEL_Z = (25.0, 15.0, 0.0, 5000.0)
RP_LIMIT = 20.0                   # deg
THRUST_BASE = 36000.0
THRUST_SCALE = 1000.0
THRUST_MIN = 20000.0
THRUST_MAX = 65535.0


class PidState(NamedTuple):
    integ: torch.Tensor
    prev_e: torch.Tensor


class FirmwarePidState(NamedTuple):
    """Carried state of the 9 PIDs of the cascade + desired-attitude memo."""

    vx: PidState
    vy: PidState
    vz: PidState
    att_roll: PidState
    att_pitch: PidState
    att_yaw: PidState
    rate_roll: PidState
    rate_pitch: PidState
    rate_yaw: PidState
    # position-loop output latched between 100 Hz updates (deg, uint16)
    des_roll: torch.Tensor
    des_pitch: torch.Tensor
    thrust: torch.Tensor


def init_state(dtype=torch.float32, device="cpu") -> FirmwarePidState:
    z = torch.zeros((), dtype=dtype, device=device)
    p = PidState(integ=z, prev_e=z)
    return FirmwarePidState(vx=p, vy=p, vz=p, att_roll=p, att_pitch=p,
                            att_yaw=p, rate_roll=p, rate_pitch=p,
                            rate_yaw=p, des_roll=z, des_pitch=z, thrust=z)


def _pid_run(state: PidState, error, dt: float, gains):
    """firmware pid.c pidUpdate: P + clamped I + finite-difference D."""
    kp, ki, kd, ilimit = gains
    integ = torch.clamp(state.integ + error * dt, -ilimit, ilimit)
    deriv = (error - state.prev_e) / dt
    out = kp * error + ki * integ + kd * deriv
    return out, PidState(integ=integ, prev_e=error)


def position_controller(fw: FirmwarePidState, dt: float,
                        pos, vel, yaw_deg, target_pos):
    """100 Hz position+velocity cascade; latches attitude setpoint + thrust.

    position_controller_pid.c positionController(): absolute-position mode
    overwrites the velocity setpoint with the position-loop output (the
    planner's velocity is not fed forward).  Internally the cascade uses
    the SIM's standard angle convention (+pitch tilts the body z axis
    toward +x, +roll toward -y, matching ops/quat); the firmware's legacy
    sign frame is applied once at the control_t output below.
    """
    vsp = POS_KP * (target_pos - pos)                    # (3,) m/s
    raw_pitch, vx_s = _pid_run(fw.vx, vsp[0] - vel[0], dt, VEL_XY)
    raw_roll, vy_s = _pid_run(fw.vy, vsp[1] - vel[1], dt, VEL_XY)
    raw_thrust, vz_s = _pid_run(fw.vz, vsp[2] - vel[2], dt, VEL_Z)
    yaw_rad = yaw_deg * DEG2RAD
    c, s = torch.cos(yaw_rad), torch.sin(yaw_rad)
    # world->body yaw rotation in the standard convention: at yaw=0 a +x
    # velocity demand needs +pitch, a +y demand needs -roll
    pitch = raw_pitch * c + raw_roll * s
    roll = -raw_roll * c + raw_pitch * s
    roll = torch.clamp(roll, -RP_LIMIT, RP_LIMIT)
    pitch = torch.clamp(pitch, -RP_LIMIT, RP_LIMIT)
    thrust = torch.clamp(raw_thrust * THRUST_SCALE + THRUST_BASE,
                         THRUST_MIN, THRUST_MAX)
    return fw._replace(vx=vx_s, vy=vy_s, vz=vz_s, des_roll=roll,
                       des_pitch=pitch, thrust=thrust)


def attitude_rate_controller(fw: FirmwarePidState, dt: float,
                             rpy_deg, gyro_deg, target_yaw_deg):
    """500 Hz angle + rate loops -> control_t moments (int16 counts).

    attitude_pid_controller.c: angle PIDs produce body-rate setpoints;
    rate PIDs produce int16-saturated outputs.  The cascade runs in the
    standard convention; the control_t output frame is legacy-inverted in
    pitch and yaw (the firmware X power distribution against the DSL
    mixer's standard torque columns: roll matches, pitch and yaw are
    negated; controller_pid.c's explicit `control->yaw = -control->yaw` is
    part of the same mapping).
    """
    yaw_e = target_yaw_deg - rpy_deg[2]
    yaw_e = torch.remainder(yaw_e + 180.0, 360.0) - 180.0  # wrap to +-180
    rr_sp, ar_s = _pid_run(fw.att_roll, fw.des_roll - rpy_deg[0], dt,
                           ATT_GAINS["roll"])
    pr_sp, ap_s = _pid_run(fw.att_pitch, fw.des_pitch - rpy_deg[1], dt,
                           ATT_GAINS["pitch"])
    yr_sp, ay_s = _pid_run(fw.att_yaw, yaw_e, dt, ATT_GAINS["yaw"])
    cmd_roll, rr_s = _pid_run(fw.rate_roll, rr_sp - gyro_deg[0], dt,
                              RATE_GAINS["roll"])
    cmd_pitch, rp_s = _pid_run(fw.rate_pitch, pr_sp - gyro_deg[1], dt,
                               RATE_GAINS["pitch"])
    cmd_yaw, ry_s = _pid_run(fw.rate_yaw, yr_sp - gyro_deg[2], dt,
                             RATE_GAINS["yaw"])
    cmd_roll = torch.clamp(cmd_roll, -INT16_MAX, INT16_MAX)
    cmd_pitch = -torch.clamp(cmd_pitch, -INT16_MAX, INT16_MAX)
    cmd_yaw = -torch.clamp(cmd_yaw, -INT16_MAX, INT16_MAX)
    fw = fw._replace(att_roll=ar_s, att_pitch=ap_s, att_yaw=ay_s,
                     rate_roll=rr_s, rate_pitch=rp_s, rate_yaw=ry_s)
    return (fw.thrust, cmd_roll, cmd_pitch, cmd_yaw), fw
