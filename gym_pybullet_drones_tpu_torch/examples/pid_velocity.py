"""4-drone velocity tracking via VelocityAviary.

    python -m gym_pybullet_drones_tpu_torch.examples.pid_velocity \
        [--device cpu]

Counterpart of the JAX package's `examples/pid_velocity.py` (the
reference's examples/pid_velocity.py: same CLI, same piecewise velocity
waypoint schedule, PYB physics at 240/48 Hz); the env's embedded DSL-PIDs
and physics step `core.step` on the device (`--device`, default the CUDA
card).
"""
import argparse
import time

import numpy as np

from gym_pybullet_drones_tpu_torch.envs import VelocityAviary
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_DRONE = DroneModel("cf2x")
DEFAULT_GUI = False
DEFAULT_RECORD_VIDEO = False
DEFAULT_PLOT = True
DEFAULT_USER_DEBUG_GUI = False
DEFAULT_OBSTACLES = False
DEFAULT_SIMULATION_FREQ_HZ = 240
DEFAULT_CONTROL_FREQ_HZ = 48
DEFAULT_DURATION_SEC = 5
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False


def run(drone=DEFAULT_DRONE, gui=DEFAULT_GUI,
        record_video=DEFAULT_RECORD_VIDEO, plot=DEFAULT_PLOT,
        user_debug_gui=DEFAULT_USER_DEBUG_GUI, obstacles=DEFAULT_OBSTACLES,
        simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, colab=DEFAULT_COLAB,
        device=None):
    INIT_XYZS = np.array(
        [[0, 0, .1], [.3, 0, .1], [.6, 0, .1], [0.9, 0, .1]])
    INIT_RPYS = np.array(
        [[0, 0, 0], [0, 0, np.pi / 3], [0, 0, np.pi / 4],
         [0, 0, np.pi / 2]])

    env = VelocityAviary(drone_model=drone, num_drones=4,
                         initial_xyzs=INIT_XYZS, initial_rpys=INIT_RPYS,
                         physics=Physics.PYB, neighbourhood_radius=10,
                         pyb_freq=simulation_freq_hz,
                         ctrl_freq=control_freq_hz, gui=gui,
                         record=record_video, obstacles=obstacles,
                         user_debug_gui=user_debug_gui, device=device)

    PERIOD = duration_sec
    NUM_WP = control_freq_hz * PERIOD
    wp_counters = np.zeros(4, dtype=int)
    # piecewise velocity schedule (reference pid_velocity.py:100-105)
    TARGET_VEL = np.zeros((4, NUM_WP, 4))
    for i in range(NUM_WP):
        TARGET_VEL[0, i] = [-0.5, 1, 0, 0.99] if i < NUM_WP / 8 \
            else [0.5, -1, 0, 0.99]
        TARGET_VEL[1, i] = [0, 1, 0, 0.99] if i < NUM_WP / 8 + NUM_WP / 6 \
            else [0, -1, 0, 0.99]
        TARGET_VEL[2, i] = [0.2, 1, 0.2, 0.99] \
            if i < NUM_WP / 8 + 2 * NUM_WP / 6 else [-0.2, -1, -0.2, 0.99]
        TARGET_VEL[3, i] = [0, 1, 0.5, 0.99] \
            if i < NUM_WP / 8 + 3 * NUM_WP / 6 else [0, -1, -0.5, 0.99]

    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=4,
                    output_folder=output_folder, colab=colab)
    action = np.zeros((4, 4), np.float32)
    START = time.time()
    obs, _ = env.reset()
    for i in range(0, int(duration_sec * env.CTRL_FREQ)):
        obs, reward, terminated, truncated, info = env.step(action)
        for j in range(4):
            action[j, :] = TARGET_VEL[j, wp_counters[j], :]
        wp_counters = np.where(wp_counters < NUM_WP - 1, wp_counters + 1, 0)
        for j in range(4):
            logger.log(drone=j, timestamp=i / env.CTRL_FREQ, state=obs[j],
                       control=np.hstack(
                           [TARGET_VEL[j, wp_counters[j], 0:3],
                            np.zeros(9)]))
        if gui:
            env.render()
            sync(i, START, env.CTRL_TIMESTEP)
    env.close()
    logger.save()
    logger.save_as_csv("vel")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Velocity control example using VelocityAviary")
    parser.add_argument("--drone", default=DEFAULT_DRONE, type=DroneModel,
                        choices=DroneModel, metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VIDEO,
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
