"""Downwash interaction demo: 2 stacked drones on crossing X-Z trajectories.

    python -m gym_pybullet_drones_tpu_torch.examples.downwash [--device cpu]

Counterpart of the JAX package's `examples/downwash.py` (the reference's
examples/downwash.py: same CLI, PYB_DW physics, same crossing cosine
trajectories with half-period phase offset); the DSL-PID
(`control/dsl_pid.compute_control_from_state`) and the env step run on the
device (`--device`, default the CUDA card).
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

DEFAULT_DRONE = DroneModel("cf2x")
DEFAULT_GUI = False
DEFAULT_RECORD_VIDEO = False
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 12
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False


def run(drone=DEFAULT_DRONE, gui=DEFAULT_GUI,
        record_video=DEFAULT_RECORD_VIDEO,
        simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, plot=True,
        colab=DEFAULT_COLAB, device=None):
    INIT_XYZS = np.array([[.5, 0, 1], [-.5, 0, .5]])
    env = CtrlAviary(drone_model=drone, num_drones=2,
                     initial_xyzs=INIT_XYZS, physics=Physics.PYB_DW,
                     neighbourhood_radius=10, pyb_freq=simulation_freq_hz,
                     ctrl_freq=control_freq_hz, gui=gui, record=record_video,
                     obstacles=True, device=device)
    dev = env.device
    PERIOD = 5
    NUM_WP = control_freq_hz * PERIOD
    TARGET_POS = np.zeros((NUM_WP, 2))
    for i in range(NUM_WP):
        TARGET_POS[i, :] = [0.5 * np.cos(2 * np.pi * (i / NUM_WP)), 0]
    wp_counters = np.array([0, int(NUM_WP / 2)])

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=2,
                    duration_sec=duration_sec, output_folder=output_folder,
                    colab=colab)
    params = get_params(drone)
    ctrl_state = dsl_pid.init_state((2,), torch.float32, dev)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)

    action = np.zeros((2, 4), np.float32)
    START = time.time()
    obs, _ = env.reset()
    for i in range(0, int(duration_sec * env.CTRL_FREQ)):
        obs, reward, terminated, truncated, info = env.step(action)
        target = np.hstack([TARGET_POS[wp_counters, :], INIT_XYZS[:, 2:3]])
        # the controller runs on the device; its rpm stays there
        action, ctrl_state, _, _ = dsl_pid.compute_control_from_state(
            params, ctrl_state, 1.0 / control_freq_hz, as_t(obs),
            target_pos=as_t(target))
        wp_counters = np.where(wp_counters < NUM_WP - 1, wp_counters + 1, 0)
        for j in range(2):
            logger.log(drone=j, timestamp=i / env.CTRL_FREQ, state=obs[j],
                       control=np.hstack([TARGET_POS[wp_counters[j], :],
                                          INIT_XYZS[j, 2], np.zeros(9)]))
        if gui:
            env.render()
            sync(i, START, env.CTRL_TIMESTEP)
    env.close()
    logger.save()
    logger.save_as_csv("dw")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Downwash example using CtrlAviary")
    parser.add_argument("--drone", default=DEFAULT_DRONE, type=DroneModel,
                        choices=DroneModel, metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VIDEO,
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
