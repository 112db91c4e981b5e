"""BetaAviary: Betaflight SITL hardware-in-the-loop bridge environment.

Counterpart of the JAX package's `envs/beta_aviary.py` (and of reference
envs/BetaAviary.py): an inherently host-side UDP bridge (the flight
controller is an external process) around `core.step`, which runs on the
aviary's `device` (None = the CUDA card):

- per-drone UDP port plan on `udp_ip`: PWM in on 9002+10i, FDM state out
  on 9003+10i, RC out on 9004+10i (reference :14-16,97-105),
- FDM packet '@dddddddddddddddddd' with ENU->NED sign flips on the body
  rates (:126-137), RC packet '@dHHHHHHHHHHHHHHHH' (:150-159),
- arming at t > ARM_TIME (1 s), trajectory from t > TRAJ_TIME (1.5 s)
  (:94-95,145-149),
- ctbr2beta mapping thrust[N]/body-rates[rad/s] -> 1000..2000 RC channels
  (:176-188),
- received PWM fractions -> RPM via sqrt(MAX_THRUST/(4 KF) * u) with the
  Betaflight motor order remap [2, 1, 3, 0] (:258-267),
- one-step action latency: the action applied this step is the PWM received
  last step (:112,170).

`use_native_bridge=True` sends and polls through the C++ bridge
(`native.SitlBridge`, built with g++ at first use; a failed build raises).
SITL process spawning is optional (spawn_sitl=False by default: the
binaries are built externally by the reference's assets/clone_bfs.sh).
"""
from __future__ import annotations

import os
import socket
import struct
import subprocess
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.envs import tasks
from gym_pybullet_drones_tpu_torch.envs.gym_adapter import (
    FunctionalAviary, _make_cfg)
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops

BASE_PORT_PWM = 9002    # out port: "API GPS" — PWM from SITL
BASE_PORT_STATE = 9003  # in port: "API RC" — FDM state to SITL
BASE_PORT_RC = 9004     # in port


class _BetaTask(tasks.CtrlTask):
    """PWM-fraction action -> RPM with the Betaflight motor remap."""

    def preprocess_action(self, cfg, state, action):
        remapped = torch.stack(
            [action[..., 2], action[..., 1], action[..., 3],
             action[..., 0]], dim=-1)
        rpm = torch.sqrt(cfg.drone.max_thrust / 4 / cfg.drone.kf * remapped)
        return rpm, state


class BetaAviary(FunctionalAviary):
    """Multi-drone environment bridging to Betaflight SITL over UDP."""

    def __init__(self, drone_model=DroneModel.CF2X, num_drones=1,
                 neighbourhood_radius=np.inf, initial_xyzs=None,
                 initial_rpys=None, physics=Physics.PYB, pyb_freq=240,
                 ctrl_freq=240, gui=False, record=False, obstacles=False,
                 user_debug_gui=True, output_folder="results",
                 udp_ip="127.0.0.1", spawn_sitl=False,
                 sitl_path=None, use_native_bridge=False, device=None):
        cfg = _make_cfg(drone_model, num_drones, neighbourhood_radius,
                        initial_xyzs, initial_rpys, physics, pyb_freq,
                        ctrl_freq)
        super().__init__(cfg, _BetaTask(), device=device)
        if spawn_sitl:
            base = sitl_path or os.path.join(
                os.path.dirname(os.path.abspath(__file__)),
                "..", "..", "betaflight_sitl")
            for i in range(num_drones):
                folder = os.path.join(base, f"bf{i}")
                subprocess.Popen(
                    ["./obj/main/betaflight_SITL.elf"], cwd=folder)
            time.sleep(2)

        self.UDP_IP = udp_ip
        self.ARM_TIME = 1
        self.TRAJ_TIME = 1.5
        self.sock = []
        self.sock_pwm = []
        self._native = None
        if use_native_bridge:
            # C++ shim: one C call per tick instead of three Python socket
            # operations (native/sitl_bridge.cpp)
            from gym_pybullet_drones_tpu_torch import native
            self._native = [native.SitlBridge(udp_ip, i)
                            for i in range(num_drones)]
        else:
            for i in range(num_drones):
                self.sock.append(socket.socket(socket.AF_INET,
                                               socket.SOCK_DGRAM))
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                s.bind((self.UDP_IP, BASE_PORT_PWM + 10 * i))
                s.settimeout(0.0)
                self.sock_pwm.append(s)
        self.beta_action = np.zeros((num_drones, 4))

    def step(self, action, i):  # noqa: A003 (reference signature)
        """action: (N, 4) CTBR commands (thrust, p, q, r); i: step index."""
        obs, reward, terminated, truncated, info = super().step(
            self.beta_action)
        t = i / self.CTRL_FREQ
        # world -> body rates via the conjugate rotation, every drone at
        # once on the host
        o = torch.from_numpy(obs)
        w_body = quat_ops.rotate_vector(
            o[:, 13:16], quat_ops.quat_conj(o[:, 3:7])).numpy()

        for j in range(self.NUM_DRONES):
            thro, roll, pitch, yaw = 1000, 1500, 1500, 1500
            if t > self.TRAJ_TIME:
                thro, roll, pitch, yaw = self.ctbr2beta(
                    *np.asarray(action[j, :]))
            aux1 = 1000 if t < self.ARM_TIME else 1500

            if self._native is not None:
                rc = np.array(
                    [round(roll), round(pitch), round(thro), round(yaw),
                     aux1] + [1000] * 11, np.uint16)
                fresh, pwm = self._native[j].tick(t, w_body[j], rc)
                if fresh:
                    self.beta_action[j, :] = pwm
                continue

            fdm_packet = struct.pack(
                "@dddddddddddddddddd",
                t,
                # ENU -> NED sign flips (reference :130)
                w_body[j, 0], -w_body[j, 1], -w_body[j, 2],
                0, 0, 0,
                1.0, 0.0, 0.0, 0.0,
                0, 0, 0,
                0, 0, 0,
                1.0)
            self.sock[j].sendto(
                fdm_packet, (self.UDP_IP, BASE_PORT_STATE + 10 * j))
            rc_packet = struct.pack(
                "@dHHHHHHHHHHHHHHHH",
                t,
                round(roll), round(pitch), round(thro), round(yaw),
                aux1, 1000, 1000, 1000,
                1000, 1000, 1000, 1000,
                1000, 1000, 1000, 1000)
            self.sock[j].sendto(
                rc_packet, (self.UDP_IP, BASE_PORT_RC + 10 * j))

            try:
                data, _ = self.sock_pwm[j].recvfrom(16)
            except OSError:      # nothing waiting: keep the last PWMs
                _action = self.beta_action[j, :]
            else:
                _action = np.array(
                    struct.unpack("@ffff", data)).reshape(4)
            self.beta_action[j, :] = _action

        return obs, reward, terminated, truncated, info

    @staticmethod
    def ctbr2beta(thrust, roll, pitch, yaw):
        """CTBR (N, rad/s) -> Betaflight RC channels (reference :176-188)."""
        MIN_CHANNEL, MAX_CHANNEL = 1000, 2000
        MAX_RATE = 360
        MAX_THRUST = 40.9
        mid = (MAX_CHANNEL + MIN_CHANNEL) / 2
        d = (MAX_CHANNEL - MIN_CHANNEL) / 2
        thrust = thrust / MAX_THRUST * d * 2 + MIN_CHANNEL
        rates = np.array([roll, pitch, -yaw])
        rates = rates / np.pi * 180 / MAX_RATE * d + mid
        thrust = np.clip(thrust, MIN_CHANNEL, MAX_CHANNEL)
        rates = np.clip(rates, MIN_CHANNEL, MAX_CHANNEL)
        return thrust, *rates

    def close(self):
        for s in self.sock + self.sock_pwm:
            s.close()
        for b in (self._native or []):
            b.close()
        super().close()
