"""Multi-drone routing demo: a fleet swaps positions via waypoint navigation.

    python -m gym_pybullet_drones_tpu_torch.examples.routing [--device cpu]

Counterpart of the JAX package's `examples/routing.py`: the routing fork's
capability (intermediate waypoints toward distant destinations, reference
BaseAviary._calculateNextStep:1105-1147) on the functional core: a
scripted router commands each drone's final destination every step; the
task's waypoint clamp turns that into safe unit steps, and the embedded
DSL-PID flies them.  `core.step` runs on the device (`--device`, default
the CUDA card).
"""
import argparse
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.envs import core
from gym_pybullet_drones_tpu_torch.envs.routing import make_routing_config
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool

DEFAULT_NUM_DRONES = 4
DEFAULT_DURATION_SEC = 10
DEFAULT_OUTPUT_FOLDER = "results"


def run(num_drones=DEFAULT_NUM_DRONES, duration_sec=DEFAULT_DURATION_SEC,
        output_folder=DEFAULT_OUTPUT_FOLDER, plot=True, gui=False,
        device=None):
    cfg, task = make_routing_config(num_drones=num_drones)
    dests = np.asarray(task.destinations)
    state, obs, _ = core.reset(cfg, task, device=device)
    dev = state.pos.device

    logger = Logger(logging_freq_hz=cfg.ctrl_freq, num_drones=num_drones,
                    output_folder=output_folder)
    # command the final goals directly
    action = torch.as_tensor(dests, dtype=torch.float32, device=dev)
    n_steps = duration_sec * cfg.ctrl_freq
    t0 = time.time()
    for i in range(n_steps):
        state, obs, reward, term, trunc, _ = core.step(cfg, task, state,
                                                       action)
        sv = core.state_vector(state).cpu().numpy()
        for j in range(num_drones):
            logger.log(drone=j, timestamp=i / cfg.ctrl_freq, state=sv[j],
                       control=np.hstack([dests[j], np.zeros(9)]))
        if bool(term):
            print(f"[INFO] all drones arrived at t={i / cfg.ctrl_freq:.2f}s")
            break
    final = state.pos.cpu().numpy()
    err = np.linalg.norm(final - dests, axis=-1)
    print(f"[RESULT] {n_steps} steps in {time.time()-t0:.1f}s; "
          f"final goal errors: {np.round(err, 3)}")
    logger.save()
    logger.save_as_csv("routing")
    if plot:
        logger.plot()
    return err


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Multi-drone routing demo")
    parser.add_argument("--num_drones", default=DEFAULT_NUM_DRONES, type=int,
                        metavar="")
    parser.add_argument("--duration_sec", default=DEFAULT_DURATION_SEC,
                        type=int, metavar="")
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str, metavar="")
    parser.add_argument("--plot", default=True, type=str2bool, metavar="")
    parser.add_argument("--gui", default=False, type=str2bool, metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
