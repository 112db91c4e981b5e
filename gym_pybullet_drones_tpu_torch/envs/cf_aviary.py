"""CFAviary: Crazyflie firmware-in-the-loop environment.

Counterpart of the JAX package's `envs/cf_aviary.py` (and of the reference
CFAviary, reference envs/CFAviary.py, which drives the C `pycffirmware`
bindings): the firmware stack — 2-pole sensor LPFs, Mellinger controller,
high-level commander, X-formation power distribution, brushed PWM curve —
is `control.firmware`, `control.firmware_pid` and `control.commander`.

The physics steps `core.step` on the aviary's `device` (None = the CUDA
card), once per firmware tick; the firmware is a host-side loop of one
drone at 500-1000 Hz and runs on the CPU in the aviary's dtype, as
`control.dsl_pid.DSLPIDControl` does: (3,)-vector controllers gain nothing
from the card.

Reproduced semantics (with reference line cites), as in the JAX package:
- env steps at the firmware rate; `step(i)` is called at ctrl_freq and runs
  firmware ticks until sim time catches up (:201-259),
- finite-difference rate/acc estimation feeding the sensor model
  (:215-218), sensor LPFs (:127-131; including the reference's swapped
  cutoff assignment: the accel LPF gets the GYRO cutoff and vice versa),
- tumble detection killing motors after 30 low-acc ticks (:377-386),
- command queue processed once per control step (:199,428-434),
- PWM -> RPM conversion 0.2685*pwm + 4070.3 (:244).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.envs import tasks
from gym_pybullet_drones_tpu_torch.envs.gym_adapter import (
    FunctionalAviary, _make_cfg)
from gym_pybullet_drones_tpu_torch.control import dsl_pid
from gym_pybullet_drones_tpu_torch.control import firmware as fw
from gym_pybullet_drones_tpu_torch.control import firmware_pid
from gym_pybullet_drones_tpu_torch.control.commander import \
    HighLevelCommander
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops

RAD_TO_DEG = 180 / math.pi


def _intrinsic_xyz_mat(rpy):
    """Rx(r) @ Ry(p) @ Rz(y) — scipy R.from_euler('XYZ', rpy) as a matrix.

    The reference marshals the body accelerometer with this INTRINSIC
    composition (reference CFAviary.py:213), not the extrinsic-xyz matrix
    its rpy state actually encodes; kept for parity.
    """
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rx @ ry @ rz


class CFAviary(FunctionalAviary):
    """Firmware-in-the-loop single-drone environment.

    CONTROLLER: 'mellinger' (default, `control.firmware`), 'pid' (the
    firmware controller_pid cascade, `control.firmware_pid`: position at
    100 Hz, attitude and rate at the firmware rate of 1000 Hz), 'dsl' (the
    DSL PID)."""

    ACTION_DELAY = 0
    SENSOR_DELAY = 0
    CONTROLLER = "mellinger"
    GYRO_LPF_CUTOFF_FREQ = 80
    ACCEL_LPF_CUTOFF_FREQ = 30
    QUAD_FORMATION_X = True

    PWM2RPM_SCALE = 0.2685
    PWM2RPM_CONST = 4070.3
    MIN_PWM = 20000
    MAX_PWM = 65535

    def __init__(self, drone_model=DroneModel.CF2X, num_drones=1,
                 neighbourhood_radius=np.inf, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=500,
                 ctrl_freq=25, gui=False, record=False, obstacles=False,
                 user_debug_gui=True, output_folder="results",
                 verbose=False, dtype=torch.float32, device=None):
        firmware_freq = 500 if self.CONTROLLER == "mellinger" else 1000
        if pyb_freq % firmware_freq != 0:
            raise ValueError(
                f"pyb_freq ({pyb_freq}) must be a multiple of firmware_freq "
                f"({firmware_freq}) for CFAviary.")
        if num_drones != 1:
            raise NotImplementedError(
                "Multi-agent support for CF Aviary is not yet implemented.")
        cfg = _make_cfg(drone_model, num_drones, neighbourhood_radius,
                        initial_xyzs, initial_rpys, physics, pyb_freq,
                        firmware_freq)
        super().__init__(cfg, tasks.CtrlTask(), dtype=dtype, device=device)
        self._ctl_dtype = dtype
        self.firmware_freq = firmware_freq
        self.ctrl_freq = ctrl_freq
        self.ctrl_dt = 1.0 / ctrl_freq
        self.firmware_dt = 1.0 / firmware_freq
        self.verbose = verbose
        self._reset_firmware()

    def _t(self, x) -> torch.Tensor:
        """A controller input: a CPU tensor in the aviary's dtype (a copy:
        the caller's arrays stay theirs)."""
        return torch.tensor(np.asarray(x), dtype=self._ctl_dtype)

    # ------------------------------------------------------------------
    def _reset_firmware(self):
        obs, info = super().reset()
        dtp = self._ctl_dtype
        # sensor LPFs: NOTE the reference initializes the accel filter with
        # the GYRO cutoff and the gyro filter with the ACCEL cutoff
        # (reference CFAviary.py:129-131); reproduced as-is.
        self._acc_lpf_coeffs = fw.lpf2p_coeffs(
            self.firmware_freq, self.GYRO_LPF_CUTOFF_FREQ)
        self._gyro_lpf_coeffs = fw.lpf2p_coeffs(
            self.firmware_freq, self.ACCEL_LPF_CUTOFF_FREQ)
        self._acc_lpf = fw.lpf2p_init((3,), dtp)
        self._gyro_lpf = fw.lpf2p_init((3,), dtp)

        self.fw_state = fw.firmware_init(dtp)
        self._fwpid_state = firmware_pid.init_state(dtp)
        self._pid_state = dsl_pid.init_state((), dtp, "cpu")
        self.commander = HighLevelCommander()
        self.command_queue: list = []
        self.full_state_cmd_override = True
        self.tick = 0
        self.last_pos_pid_call = 0.0
        self.last_att_pid_call = 0.0
        self.pwms = np.zeros(4)
        self.action = np.zeros((1, 4))
        self.tumble_counter = 0
        self._error = False
        self.first_motor_killed_print = True
        self.takeoff_sent = False
        self.states_log: list = []

        self.prev_vel = np.asarray(obs[0][10:13])
        self.prev_rpy = np.asarray(obs[0][7:10])
        # the firmware's setpoint_t starts zero-initialized: until the first
        # command arrives the controllers target the ORIGIN, not the spawn
        # point (reference CFAviary.py:135 firm.setpoint_t())
        self._setpoint = fw.Setpoint(
            position=torch.zeros(3, dtype=dtp),
            velocity=torch.zeros(3, dtype=dtp),
            acceleration=torch.zeros(3, dtype=dtp),
            attitude_rate=torch.zeros(3, dtype=dtp),
            quat=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtp))
        self.commander.tell_state(obs[0][0:3], obs[0][9])
        return obs, info

    def reset(self, seed=None, options=None):
        return self._reset_firmware()

    # ------------------------------------------------------------------
    def step(self, i):
        """Advance by one control period (i is the control-step index)."""
        t = i / self.ctrl_freq
        self._process_command_queue(t)

        obs = reward = terminated = truncated = info = None
        while self.tick / self.firmware_freq < t + self.ctrl_dt:
            obs, reward, terminated, truncated, info = super().step(
                self.action)
            cur_pos = np.asarray(obs[0][0:3])
            cur_vel = np.asarray(obs[0][10:13])
            cur_rpy = np.asarray(obs[0][7:10])
            cur_quat = np.asarray(obs[0][3:7])

            if self.takeoff_sent:
                self.states_log.append(
                    [self.tick / self.firmware_freq, *cur_pos])

            # finite-difference rates/acc (reference :215-218)
            rates = (cur_rpy - self.prev_rpy) / self.firmware_dt
            self.prev_rpy = cur_rpy
            acc_world = ((cur_vel - self.prev_vel) / self.firmware_dt / 9.8
                         + np.array([0, 0, 1]))
            self.prev_vel = cur_vel

            # body-frame accelerometer reading + LPFs.  NOTE the reference
            # rotates with scipy R.from_euler('XYZ', rpy).inv()
            # (CFAviary.py:213) — an INTRINSIC XYZ composition
            # (Rx(r)Ry(p)Rz(y))^T, which is NOT the transpose of the
            # extrinsic-xyz attitude matrix the state rpy encodes; the
            # quirk is reproduced as-is.
            acc_body = _intrinsic_xyz_mat(cur_rpy).T @ acc_world
            acc_f, self._acc_lpf = fw.lpf2p_apply(
                self._acc_lpf_coeffs, self._acc_lpf, self._t(acc_body))
            gyro_f, self._gyro_lpf = fw.lpf2p_apply(
                self._gyro_lpf_coeffs, self._gyro_lpf,
                self._t(rates * RAD_TO_DEG))

            # high-level commander setpoint (unless full-state override)
            self._update_setpoint(self.tick / self.firmware_freq,
                                  cur_pos, cur_rpy[2])

            # tumble detection (reference :377-386) — the marshaled
            # state.acc is the WORLD-frame finite-difference acc in Gs
            # (:229-231), so the check watches acc_world, not the filtered
            # body acc
            if acc_world[2] < -0.5:
                self.tumble_counter += 1
            else:
                self.tumble_counter = 0
            if self.tumble_counter >= 30 or self._error:
                if self.first_motor_killed_print and not self._error:
                    print("WARNING: CrazyFlie is Tumbling. "
                          "Killing motors to save propellers.")
                    self.first_motor_killed_print = False
                self._error = True
                self.pwms = np.zeros(4)
                self.action = np.zeros((1, 4))
                self.tick += 1
                continue

            # Wall-clock controller scheduling, float-for-float as the
            # reference computes it (CFAviary.py:388-398): _tick=0 runs
            # position+attitude, 2 attitude only, 1 neither.  The strict >
            # comparisons on cur_time differences make the firing pattern
            # irregular (e.g. at 1000 Hz attitude fires on ticks 3, 5, 8,
            # 10, ... — not every 2nd tick), so a modulo schedule does NOT
            # reproduce it.
            cur_time = self.tick / self.firmware_freq
            if (cur_time - self.last_att_pid_call > 0.002
                    and cur_time - self.last_pos_pid_call > 0.01):
                _tick = 0
                self.last_pos_pid_call = cur_time
                self.last_att_pid_call = cur_time
            elif cur_time - self.last_att_pid_call > 0.002:
                self.last_att_pid_call = cur_time
                _tick = 2
            else:
                _tick = 1

            if self.CONTROLLER == "pid":
                # firmware controller_pid RATE_DO_EXECUTE over the 1000 Hz
                # main loop: position at 100 Hz (_tick % 10 == 0), attitude
                # + rate at 500 Hz (_tick % 2 == 0)
                fs = self._fwpid_state
                rpy_deg = cur_rpy * RAD_TO_DEG
                if _tick % 10 == 0:
                    fs = firmware_pid.position_controller(
                        fs, 1.0 / 100.0, self._t(cur_pos),
                        self._t(cur_vel), self._t(rpy_deg[2]),
                        self._setpoint.position)
                if _tick % 2 == 0:
                    sp_yaw_deg = float(np.degrees(quat_ops.quat_to_rpy(
                        self._setpoint.quat).numpy())[2])
                    control, fs = firmware_pid.attitude_rate_controller(
                        fs, 1.0 / 500.0, self._t(rpy_deg), gyro_f,
                        self._t(sp_yaw_deg))
                    self.pwms = fw.power_distribution(
                        torch.stack(control), self.QUAD_FORMATION_X).numpy()
                self._fwpid_state = fs
            elif self.CONTROLLER == "dsl":
                rpm_cmd, self._pid_state, _, _ = dsl_pid.compute_control(
                    self.cfg.drone, self._pid_state, self.firmware_dt,
                    self._t(cur_pos), self._t(cur_quat), self._t(cur_vel),
                    target_pos=self._setpoint.position,
                    target_vel=self._setpoint.velocity)
                self.pwms = np.clip(
                    (rpm_cmd.numpy() - self.PWM2RPM_CONST)
                    / self.PWM2RPM_SCALE, 0, self.MAX_PWM)
            elif _tick % 2 == 0:
                # controller_mellinger.c: one RATE_DO_EXECUTE(ATTITUDE_RATE)
                # gate over the whole tick; skipped ticks keep the previous
                # pwms.  The step is the firmware's RATE constant, not the
                # interval between executions.
                control, self.fw_state = fw.mellinger_control(
                    self.fw_state, self._setpoint, self._t(cur_pos),
                    self._t(cur_vel), self._t(cur_quat), gyro_f,
                    1.0 / 500.0)
                self.pwms = fw.power_distribution(
                    control, self.QUAD_FORMATION_X).numpy()
            rpm = self.PWM2RPM_SCALE * np.clip(
                self.pwms, self.MIN_PWM, self.MAX_PWM) + self.PWM2RPM_CONST
            self.action = rpm[None, :]
            self.tick += 1
        return obs, reward, terminated, truncated, info

    # ------------------------------------------------------------------
    def _yaw_quat(self, yaw) -> torch.Tensor:
        return quat_ops.rpy_to_quat(self._t([0, 0, yaw]))

    def _update_setpoint(self, timestep, cur_pos, cur_yaw):
        if not self.full_state_cmd_override:
            self.commander.tell_state(cur_pos, cur_yaw)
            self.commander.update_time(timestep)
            pos, vel, acc, yaw = self.commander.get_setpoint()
            self._setpoint = fw.Setpoint(
                position=self._t(pos), velocity=self._t(vel),
                acceleration=self._t(acc),
                attitude_rate=torch.zeros(3, dtype=self._ctl_dtype),
                quat=self._yaw_quat(yaw))

    def _process_command_queue(self, sim_time):
        if self.command_queue:
            self.commander.stop()
            self.commander.update_time(sim_time)
            command, args = self.command_queue.pop(0)
            getattr(self, command)(*args)

    # -- command surface (reference :435-606) ---------------------------
    def sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self.command_queue.append(
            ["_sendFullStateCmd", [pos, vel, acc, yaw, rpy_rate, timestep]])

    def _sendFullStateCmd(self, pos, vel, acc, yaw, rpy_rate, timestep):
        self._setpoint = fw.Setpoint(
            position=self._t(pos), velocity=self._t(vel),
            acceleration=self._t(acc),
            attitude_rate=self._t(np.asarray(rpy_rate) * RAD_TO_DEG),
            quat=self._yaw_quat(yaw))
        self.full_state_cmd_override = True

    def sendTakeoffCmd(self, height, duration):
        self.command_queue.append(["_sendTakeoffCmd", [height, duration]])

    def _sendTakeoffCmd(self, height, duration):
        print(f"INFO_{self.tick}: Takeoff command sent.")
        self.takeoff_sent = True
        self.commander.takeoff(height, duration)
        self.full_state_cmd_override = False

    def sendTakeoffYawCmd(self, height, duration, yaw):
        self.command_queue.append(
            ["_sendTakeoffYawCmd", [height, duration, yaw]])

    def _sendTakeoffYawCmd(self, height, duration, yaw):
        self.commander.takeoff(height, duration, yaw)
        self.full_state_cmd_override = False

    def sendTakeoffVelCmd(self, height, vel, relative):
        self.command_queue.append(
            ["_sendTakeoffVelCmd", [height, vel, relative]])

    def _sendTakeoffVelCmd(self, height, vel, relative):
        self.commander.takeoff_with_velocity(height, vel, relative)
        self.full_state_cmd_override = False

    def sendLandCmd(self, height, duration):
        self.command_queue.append(["_sendLandCmd", [height, duration]])

    def _sendLandCmd(self, height, duration):
        print(f"INFO_{self.tick}: Land command sent.")
        self.commander.land(height, duration)
        self.full_state_cmd_override = False

    def sendLandYawCmd(self, height, duration, yaw):
        self.command_queue.append(
            ["_sendLandYawCmd", [height, duration, yaw]])

    def _sendLandYawCmd(self, height, duration, yaw):
        self.commander.land(height, duration, yaw)
        self.full_state_cmd_override = False

    def sendLandVelCmd(self, height, vel, relative):
        self.command_queue.append(
            ["_sendLandVelCmd", [height, vel, relative]])

    def _sendLandVelCmd(self, height, vel, relative):
        self.commander.land_with_velocity(height, vel, relative)
        self.full_state_cmd_override = False

    def sendStopCmd(self):
        self.command_queue.append(["_sendStopCmd", []])

    def _sendStopCmd(self):
        self.commander.stop()
        self.full_state_cmd_override = False

    def sendGotoCmd(self, pos, yaw, duration_s, relative):
        self.command_queue.append(
            ["_sendGotoCmd", [pos, yaw, duration_s, relative]])

    def _sendGotoCmd(self, pos, yaw, duration_s, relative):
        print(f"INFO_{self.tick}: Go to command sent.")
        self.commander.go_to(*pos, yaw, duration_s, relative)
        self.full_state_cmd_override = False

    def notifySetpointStop(self):
        self.command_queue.append(["_notifySetpointStop", []])

    def _notifySetpointStop(self):
        self.full_state_cmd_override = False
