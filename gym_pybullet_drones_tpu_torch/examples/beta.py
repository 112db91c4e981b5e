"""Betaflight SITL flight: BetaAviary + CTBRControl at 500/500 Hz.

    python -m gym_pybullet_drones_tpu_torch.examples.beta [--device cpu]

Counterpart of the JAX package's `examples/beta.py` (the reference's
examples/beta.py): the physics steps on `--device` (default the CUDA
card), the CTBR controller and the UDP bridge on the host.  The reference
replays CSV
trajectories shipped in its assets; here the default trajectory is a
generated smooth circuit of the same character, and --traj_csv accepts any
CSV with p_x,p_y,p_z,v_x,v_y,v_z columns for replay parity.

Requires Betaflight SITL binaries (see the reference's assets/clone_bfs.sh);
run with --spawn_sitl True once they are built, or start them manually.
Without a SITL no PWM arrives and the drones fall.
"""
import argparse
import csv
import os
import time

import numpy as np

import gym_pybullet_drones_tpu_torch
from gym_pybullet_drones_tpu_torch.control.ctbr import CTBRControl
from gym_pybullet_drones_tpu_torch.envs.beta_aviary import BetaAviary
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_DRONES = DroneModel("racer")
DEFAULT_PHYSICS = Physics("pyb")
DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_USER_DEBUG_GUI = False
DEFAULT_SIMULATION_FREQ_HZ = 500
DEFAULT_CONTROL_FREQ_HZ = 500
DEFAULT_DURATION_SEC = 20
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_NUM_DRONES = 2


def _default_trajectory(n_steps, dt):
    """Smooth climb + circle, yielding dicts like the reference CSV rows."""
    for k in range(n_steps):
        t = k * dt
        if t < 2.0:
            pos = np.array([0.0, 0.0, 0.5 * t])
            vel = np.array([0.0, 0.0, 0.5])
        else:
            w = 2 * np.pi / 6.0
            s = t - 2.0
            pos = np.array([np.cos(w * s) - 1, np.sin(w * s), 1.0])
            vel = np.array([-w * np.sin(w * s), w * np.cos(w * s), 0.0])
        yield {"pos": pos, "vel": vel}


def _csv_trajectory(path):
    with open(path) as f:
        for row in csv.DictReader(f):
            yield {"pos": np.array([float(row["p_x"]), float(row["p_y"]),
                                    float(row["p_z"])]),
                   "vel": np.array([float(row["v_x"]), float(row["v_y"]),
                                    float(row["v_z"])])}


def run(drone=DEFAULT_DRONES, num_drones=DEFAULT_NUM_DRONES,
        physics=DEFAULT_PHYSICS, gui=DEFAULT_GUI, plot=DEFAULT_PLOT,
        user_debug_gui=DEFAULT_USER_DEBUG_GUI,
        simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, traj_csv=None,
        spawn_sitl=False, udp_ip="127.0.0.1", device=None):
    INIT_XYZ = np.array([[.3 * i, .3 * i, .1]
                         for i in range(1, num_drones + 1)])
    INIT_RPY = np.array([[0.0, 0.0, 0.0] for _ in range(num_drones)])
    env = BetaAviary(drone_model=drone, num_drones=num_drones,
                     initial_xyzs=INIT_XYZ, initial_rpys=INIT_RPY,
                     physics=physics, pyb_freq=simulation_freq_hz,
                     ctrl_freq=control_freq_hz, gui=gui,
                     user_debug_gui=user_debug_gui, spawn_sitl=spawn_sitl,
                     udp_ip=udp_ip, device=device)
    ctrl = CTBRControl(drone_model=drone)
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder)

    n_steps = int(duration_sec * env.CTRL_FREQ)
    if traj_csv is None:
        # default to the shipped asset (counterpart of the reference's
        # assets/beta-traj.csv, examples/beta.py:91); fall back to the
        # generated circuit if the asset is absent
        shipped = os.path.join(
            os.path.dirname(gym_pybullet_drones_tpu_torch.__file__),
            "assets", "beta-traj.csv")
        if os.path.exists(shipped):
            traj_csv = shipped
    make_traj = (lambda: _csv_trajectory(traj_csv)) if traj_csv else \
        (lambda: _default_trajectory(n_steps, env.CTRL_TIMESTEP))
    trajectories = [make_traj() for _ in range(num_drones)]

    action = np.zeros((num_drones, 4))
    START = time.time()
    obs, _ = env.reset()
    for i in range(n_steps):
        t = i / env.CTRL_FREQ
        obs, reward, terminated, truncated, info = env.step(action, i)
        if t > env.TRAJ_TIME:
            for j in range(num_drones):
                try:
                    target = next(trajectories[j])
                except StopIteration:
                    break
                action[j, :] = ctrl.computeControlFromState(
                    control_timestep=env.CTRL_TIMESTEP, state=obs[j],
                    target_pos=target["pos"] + np.array(
                        [INIT_XYZ[j][0], INIT_XYZ[j][1], 0]),
                    target_vel=target["vel"])
        for j in range(num_drones):
            logger.log(drone=j, timestamp=t, state=obs[j])
        if gui:
            env.render()
            sync(i, START, env.CTRL_TIMESTEP)
    env.close()
    logger.save()
    logger.save_as_csv("beta")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Test flight script using SITL Betaflight")
    parser.add_argument("--drone", default=DEFAULT_DRONES, type=DroneModel,
                        choices=DroneModel, metavar="")
    parser.add_argument("--num_drones", default=DEFAULT_NUM_DRONES, type=int,
                        metavar="")
    parser.add_argument("--physics", default=DEFAULT_PHYSICS, type=Physics,
                        choices=Physics, metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool,
                        metavar="")
    parser.add_argument("--user_debug_gui", default=DEFAULT_USER_DEBUG_GUI,
                        type=str2bool, metavar="")
    parser.add_argument("--simulation_freq_hz",
                        default=DEFAULT_SIMULATION_FREQ_HZ, type=int,
                        metavar="")
    parser.add_argument("--control_freq_hz", default=DEFAULT_CONTROL_FREQ_HZ,
                        type=int, metavar="")
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC,
                        type=int, metavar="")
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str, metavar="")
    parser.add_argument("--traj_csv", default=None, type=str, metavar="")
    parser.add_argument("--spawn_sitl", default=False, type=str2bool,
                        metavar="")
    parser.add_argument("--udp_ip", default="127.0.0.1", type=str,
                        help="the SITL's address", metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
