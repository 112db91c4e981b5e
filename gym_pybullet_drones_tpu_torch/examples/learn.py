"""PPO training on Hover / MultiHover, on the card.

    python -m gym_pybullet_drones_tpu_torch.examples.learn [--multiagent True]
    python -m gym_pybullet_drones_tpu_torch.examples.learn --local False \\
        --device cpu      # the 100-step smoke budget, on the host

Counterpart of the JAX package's `examples/learn.py`: the same flags, the
same reward thresholds (474.15 / 949.5 for ONE_D_RPM, else 467 / 920), the
same 1e7-local / 1e2-test budgets and the same configuration (PYB physics,
240 Hz under 30 Hz control; 64 envs x 64 steps, 4 minibatches, 10 epochs),
with the port's PPO (`rl/ppo.py`): the env steps through the fused env
kernel on the card, one launch per control step.  An evaluation
(`evaluate(episodic=True)`) runs every 10 updates and at the last one, and
training stops at the target.  `best_model.pt` and `final_model.pt` are
torch `state_dict`s of the ActorCritic.

Then, as in the JAX script, the trained policy's deterministic action
replays in the class env (`HoverAviary` / `MultiHoverAviary`, on the same
device) for EPISODE_LEN_SEC + 2 seconds, resetting where an episode ends,
with `--gui` and `--record_video` as there; the states are logged and,
for KIN observations, plotted (`plot`; matplotlib).  `--colab` only chose
how the plot is shown and has no effect.
"""
import argparse
import os
import time
from datetime import datetime

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import (
    AviaryConfig, HoverAviary, HoverTask, MultiHoverAviary, MultiHoverTask)
from gym_pybullet_drones_tpu_torch.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)
from gym_pybullet_drones_tpu_torch.utils.logger import Logger
from gym_pybullet_drones_tpu_torch.utils.utils import str2bool, sync

DEFAULT_GUI = False
DEFAULT_RECORD_VIDEO = False
DEFAULT_OUTPUT_FOLDER = "results"
DEFAULT_COLAB = False
DEFAULT_OBS = ObservationType("kin")
DEFAULT_ACT = ActionType("one_d_rpm")
DEFAULT_AGENTS = 2
DEFAULT_MA = False


def run(multiagent=DEFAULT_MA, output_folder=DEFAULT_OUTPUT_FOLDER,
        gui=DEFAULT_GUI, plot=True, colab=DEFAULT_COLAB,
        record_video=DEFAULT_RECORD_VIDEO, local=True, obs=DEFAULT_OBS,
        act=DEFAULT_ACT, num_envs=64, seed=0, device=None):
    device = resolve_device(device)
    filename = os.path.join(
        output_folder,
        "save-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"))
    os.makedirs(filename, exist_ok=True)

    num_drones = DEFAULT_AGENTS if multiagent else 1
    env_cfg = AviaryConfig(drone=P.CF2X, num_drones=num_drones,
                           physics=Physics.PYB, pyb_freq=240, ctrl_freq=30)
    task_cls = MultiHoverTask if multiagent else HoverTask
    task = task_cls(act=ActionType(act), obs=ObservationType(obs))

    # reward thresholds (reference learn.py:78-83)
    if ActionType(act) == ActionType.ONE_D_RPM:
        target = 949.5 if multiagent else 474.15
    else:
        target = 920.0 if multiagent else 467.0

    total_timesteps = int(1e7) if local else int(1e2)
    ppo = PPOConfig(num_envs=num_envs, rollout_steps=64,
                    num_minibatches=4, update_epochs=10,
                    total_timesteps=total_timesteps)
    init, update, evaluate, network = make_train(env_cfg, task, ppo,
                                                 device=device)
    ts = init(torch.Generator(device).manual_seed(seed))

    start = time.time()
    best_eval = -np.inf
    num_updates = ppo.num_updates
    for u in range(num_updates):
        ts, metrics = update(ts)
        if u % 10 == 0 or u == num_updates - 1:
            # reference eval protocol: episodic accounting over
            # episode_len_sec * ctrl_freq + 2 control steps (QUIRKS.md #11)
            mean_ret = float(evaluate(ts.network, episodic=True).mean())
            print(f"update {u}/{num_updates} steps={(u + 1) * ppo.batch_size} "
                  f"eval_return={mean_ret:.2f} "
                  f"mean_reward={float(metrics['mean_reward']):.3f} "
                  f"({time.time() - start:.0f}s)", flush=True)
            if mean_ret > best_eval:
                best_eval = mean_ret
                torch.save(ts.network.state_dict(),
                           os.path.join(filename, "best_model.pt"))
            if mean_ret >= target:
                print(f"[INFO] reached target reward {target}; "
                      "stopping early")
                break
    torch.save(ts.network.state_dict(),
               os.path.join(filename, "final_model.pt"))
    print(f"[RESULT] best eval return {best_eval:.2f} (target {target})")

    # ---- replay the trained policy in the class-based env ----
    env_cls = MultiHoverAviary if multiagent else HoverAviary
    test_env = env_cls(gui=gui, obs=ObservationType(obs),
                       act=ActionType(act), record=record_video,
                       device=device)
    logger = Logger(logging_freq_hz=test_env.CTRL_FREQ,
                    num_drones=num_drones, output_folder=output_folder,
                    colab=colab)
    obs_arr, info = test_env.reset(seed=42)
    start = time.time()
    total_r = 0.0
    with torch.no_grad():
        for i in range(int(test_env.EPISODE_LEN_SEC + 2)
                       * test_env.CTRL_FREQ):
            flat = torch.as_tensor(obs_arr.reshape(1, -1), device=device)
            action = ts.network(flat)[0].reshape(num_drones, -1)
            obs_arr, reward, terminated, truncated, _ = test_env.step(action)
            total_r += reward
            for d in range(num_drones):
                logger.log(drone=d, timestamp=i / test_env.CTRL_FREQ,
                           state=test_env.getDroneStateVector(d))
            if gui:
                test_env.render()
                sync(i, start, test_env.CTRL_TIMESTEP)
            if terminated or truncated:
                obs_arr, info = test_env.reset(seed=42)
    test_env.close()
    print(f"[RESULT] replay accumulated reward {total_r:.2f}")
    if plot and ObservationType(obs) == ObservationType.KIN:
        logger.plot()
    return best_eval


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="PPO hover example")
    parser.add_argument("--multiagent", default=DEFAULT_MA, type=str2bool,
                        help="single or multi-agent", metavar="")
    parser.add_argument("--gui", default=DEFAULT_GUI, type=str2bool,
                        metavar="")
    parser.add_argument("--record_video", default=DEFAULT_RECORD_VIDEO,
                        type=str2bool, metavar="")
    parser.add_argument("--output_folder", default=DEFAULT_OUTPUT_FOLDER,
                        type=str, metavar="")
    parser.add_argument("--plot", default=True, type=str2bool,
                        help="plot the replay's states (needs matplotlib)",
                        metavar="")
    parser.add_argument("--colab", default=DEFAULT_COLAB, type=bool,
                        metavar="")
    parser.add_argument("--local", default=True, type=str2bool,
                        help="full budget if True, smoke budget if False",
                        metavar="")
    parser.add_argument("--num_envs", default=64, type=int,
                        help="parallel envs for the on-device learner",
                        metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card; 'cpu' "
                             "runs the kernels' plain versions)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
