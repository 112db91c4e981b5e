"""Flagship demo: CtrlAviary + DSL PID tracking circular helix waypoints.

    python -m gym_pybullet_drones_tpu_torch.examples.pid [--device cpu]

Counterpart of the JAX package's `examples/pid.py` (the reference's
examples/pid.py: same CLI flags, same 3-drone circular trajectory around
(0, -0.3), same 240/48 Hz rates): the per-drone Python controller loop of
the reference (pid.py:141-147) is one batched call of the port's
`control/dsl_pid.compute_control_from_state` on the device, and the env
steps `core.step` there (`--device`, default the CUDA card).
"""
import argparse
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.control import dsl_pid
from gym_pybullet_drones_tpu_torch.envs import CtrlAviary
from gym_pybullet_drones_tpu_torch.params import get_params
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_DRONES = DroneModel("cf2x")
DEFAULT_NUM_DRONES = 3
DEFAULT_PHYSICS = Physics("pyb")
DEFAULT_GUI = False
DEFAULT_RECORD_VISION = False
DEFAULT_PLOT = True
DEFAULT_USER_DEBUG_GUI = False
DEFAULT_OBSTACLES = True
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False


def run(drone=DEFAULT_DRONES, num_drones=DEFAULT_NUM_DRONES,
        physics=DEFAULT_PHYSICS, gui=DEFAULT_GUI,
        record_video=DEFAULT_RECORD_VISION, plot=DEFAULT_PLOT,
        user_debug_gui=DEFAULT_USER_DEBUG_GUI, obstacles=DEFAULT_OBSTACLES,
        simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, colab=DEFAULT_COLAB,
        device=None):
    # circular helix init + waypoints (reference pid.py:64-77)
    H, H_STEP, R = 0.1, 0.05, 0.3
    INIT_XYZS = np.array([
        [R * np.cos((i / 6) * 2 * np.pi + np.pi / 2),
         R * np.sin((i / 6) * 2 * np.pi + np.pi / 2) - R,
         H + i * H_STEP] for i in range(num_drones)])
    INIT_RPYS = np.array(
        [[0, 0, i * (np.pi / 2) / num_drones] for i in range(num_drones)])
    PERIOD = 10
    NUM_WP = control_freq_hz * PERIOD
    TARGET_POS = np.zeros((NUM_WP, 3))
    for i in range(NUM_WP):
        TARGET_POS[i, :] = (
            R * np.cos((i / NUM_WP) * 2 * np.pi + np.pi / 2) + INIT_XYZS[0, 0],
            R * np.sin((i / NUM_WP) * 2 * np.pi + np.pi / 2) - R
            + INIT_XYZS[0, 1], 0)
    wp_counters = np.array(
        [int((i * NUM_WP / 6) % NUM_WP) for i in range(num_drones)])

    env = CtrlAviary(drone_model=drone, num_drones=num_drones,
                     initial_xyzs=INIT_XYZS, initial_rpys=INIT_RPYS,
                     physics=physics, neighbourhood_radius=10,
                     pyb_freq=simulation_freq_hz, ctrl_freq=control_freq_hz,
                     gui=gui, record=record_video, obstacles=obstacles,
                     user_debug_gui=user_debug_gui,
                     output_folder=output_folder, device=device)
    dev = env.device
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=num_drones,
                    output_folder=output_folder, colab=colab)

    if drone not in (DroneModel.CF2X, DroneModel.CF2P):
        raise ValueError(
            "DSL PID supports cf2x/cf2p only (reference pid.py:126-127)")
    params = get_params(drone)
    ctrl_state = dsl_pid.init_state((num_drones,), torch.float32, dev)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    target_rpy = as_t(INIT_RPYS)

    action = np.zeros((num_drones, 4), np.float32)
    START = time.time()
    obs, info = env.reset()
    for i in range(0, int(duration_sec * env.CTRL_FREQ)):
        obs, reward, terminated, truncated, info = env.step(action)
        target_pos = np.hstack([
            TARGET_POS[wp_counters, 0:2], INIT_XYZS[:, 2:3]])
        # the controller runs on the device; its rpm stays there
        action, ctrl_state, _, _ = dsl_pid.compute_control_from_state(
            params, ctrl_state, 1.0 / control_freq_hz, as_t(obs),
            target_pos=as_t(target_pos), target_rpy=target_rpy)
        wp_counters = np.where(wp_counters < NUM_WP - 1, wp_counters + 1, 0)
        for j in range(num_drones):
            logger.log(drone=j, timestamp=i / env.CTRL_FREQ, state=obs[j],
                       control=np.hstack([TARGET_POS[wp_counters[j], 0:2],
                                          INIT_XYZS[j, 2], INIT_RPYS[j, :],
                                          np.zeros(6)]))
        if gui:
            env.render()
            sync(i, START, env.CTRL_TIMESTEP)
    env.close()
    logger.save()
    logger.save_as_csv("pid")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Helix flight script using CtrlAviary and DSLPIDControl")
    parser.add_argument("--drone", default=DEFAULT_DRONES, type=DroneModel,
                        choices=DroneModel, metavar="")
    parser.add_argument("--num_drones", default=DEFAULT_NUM_DRONES, type=int,
                        metavar="")
    parser.add_argument("--physics", default=DEFAULT_PHYSICS, type=Physics,
                        choices=Physics, metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VISION,
                        type=str2bool, metavar="")
    parser.add_argument("--plot", default=DEFAULT_PLOT, type=str2bool,
                        metavar="")
    parser.add_argument("--user_debug_gui", default=DEFAULT_USER_DEBUG_GUI,
                        type=str2bool, metavar="")
    parser.add_argument("--obstacles", default=DEFAULT_OBSTACLES,
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
    parser.add_argument("--colab", default=DEFAULT_COLAB, type=bool,
                        metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
