"""Firmware-in-the-loop flight: CFAviary square trajectory via full-state cmds.

    python -m gym_pybullet_drones_tpu_torch.examples.cf [--device cpu]

Counterpart of the JAX package's `examples/cf.py` (the reference's
examples/cf.py: same 500/25 Hz rates, same square trajectory commanded
through sendFullStateCmd).  The physics steps on `--device` (default the
CUDA card), once per firmware tick; the firmware runs on the CPU.
`run(duration_fraction=...)` cuts the 21 s flight to its first fraction.
"""
import argparse
import time

import numpy as np

from gym_pybullet_drones_tpu_torch.envs.cf_aviary import CFAviary
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_DRONES = DroneModel("cf2x")
DEFAULT_PHYSICS = Physics("pyb")
DEFAULT_GUI = False
DEFAULT_PLOT = True
DEFAULT_USER_DEBUG_GUI = False
DEFAULT_SIMULATION_FREQ_HZ = 500
DEFAULT_CONTROL_FREQ_HZ = 25
DEFAULT_OUTPUT_FOLDER = "results"
NUM_DRONES = 1
INIT_XYZ = np.array([[.5 * i, .5 * i, .1] for i in range(NUM_DRONES)])
INIT_RPY = np.array([[0.0, 0.0, 0.0] for _ in range(NUM_DRONES)])


def run(drone=DEFAULT_DRONES, physics=DEFAULT_PHYSICS, gui=DEFAULT_GUI,
        plot=DEFAULT_PLOT, user_debug_gui=DEFAULT_USER_DEBUG_GUI,
        simulation_freq_hz=DEFAULT_SIMULATION_FREQ_HZ,
        control_freq_hz=DEFAULT_CONTROL_FREQ_HZ,
        output_folder=DEFAULT_OUTPUT_FOLDER, duration_fraction=1.0,
        device=None):
    env = CFAviary(drone_model=drone, num_drones=NUM_DRONES,
                   initial_xyzs=INIT_XYZ, initial_rpys=INIT_RPY,
                   physics=physics, pyb_freq=simulation_freq_hz,
                   ctrl_freq=control_freq_hz, gui=gui,
                   user_debug_gui=user_debug_gui, device=device)
    logger = Logger(logging_freq_hz=control_freq_hz, num_drones=NUM_DRONES,
                    output_folder=output_folder)

    # square trajectory via full-state commands (reference cf.py:74-99)
    delta = 75  # 3 s @ 25 Hz control loop
    trajectory = [[0, 0, 0] for i in range(delta)] + \
        [[0, 0, i / delta] for i in range(delta)] + \
        [[i / delta, 0, 1] for i in range(delta)] + \
        [[1, i / delta, 1] for i in range(delta)] + \
        [[1 - i / delta, 1, 1] for i in range(delta)] + \
        [[0, 1 - i / delta, 1] for i in range(delta)] + \
        [[0, 0, 1 - i / delta] for i in range(delta)]
    trajectory = trajectory[:int(len(trajectory) * duration_fraction)]

    START = time.time()
    obs = None
    for i in range(len(trajectory)):
        t = i / env.ctrl_freq
        obs, reward, terminated, truncated, info = env.step(i)
        for j in range(NUM_DRONES):
            target = trajectory[i]
            pos = np.asarray(target) + np.array(
                [INIT_XYZ[j][0], INIT_XYZ[j][1], 0])
            env.sendFullStateCmd(pos, np.zeros(3), np.zeros(3),
                                 i * np.pi / delta / 2, np.zeros(3), t)
        for j in range(NUM_DRONES):
            logger.log(drone=j, timestamp=i / env.CTRL_FREQ, state=obs[j])
        if gui:
            env.render()
            sync(i, START, env.CTRL_TIMESTEP)
    env.close()
    logger.save()
    logger.save_as_csv("cf")
    if plot:
        logger.plot()
    return logger


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Firmware-in-the-loop flight script using CFAviary")
    parser.add_argument("--drone", default=DEFAULT_DRONES, type=DroneModel,
                        choices=DroneModel, metavar="")
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
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str, metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
