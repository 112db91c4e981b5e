"""Swarm showcase: thousands of routing fleets advancing in lockstep.

    python -m gym_pybullet_drones_tpu_torch.examples.swarm \\
        --num_envs 4096 --num_drones 4 [--device cpu]

Counterpart of the JAX package's `examples/swarm.py`: a batch of
multi-drone routing environments — tens of thousands of drones — advances
through `envs/fast.make_batched_step` on the card, one launch of the
`env_ctrl_step` kernel (PYB physics with the embedded DSL-PID tick) a
control step, in a Python loop where the JAX script scans; then a frame of
one fleet is ray-traced from the same state by the plain renderer
(`ops/render.py`).
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.envs.fast import make_batched_step
from gym_pybullet_drones_tpu_torch.envs.routing import make_routing_config
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import Physics
from gym_pybullet_drones_tpu_torch.utils.utils import require, str2bool


def fly(num_envs=4096, num_drones=4, duration_sec=8, device=None):
    """The scripted flight of `num_envs` fleets: (cfg, final flat state,
    share of drones within 15 cm of their goal, mean goal error [m],
    control steps, seconds of the timed loop).  The timed loop starts from
    the reset after one warm-up step and ends in a synchronize and a host
    readback of the reward sum."""
    device = resolve_device(device)
    # PYB physics: the closed-loop PID is stable there (the DYN mode's
    # inverted roll-torque quirk, inherited from the reference, makes
    # PID-controlled flight tumble in DYN)
    cfg, task = make_routing_config(num_drones=num_drones,
                                    physics=Physics.PYB)
    # scripted flight: absolute waypoint commands (the reference
    # BaseRLAviary PID convention); the trainable default is
    # relative_actions=True (see envs/routing.py).  The routing goals are
    # deliberately crossing paths, and a scripted mid-air collision tumbles
    # drones just like Bullet's — so the script flies the de-conflicted
    # two-leg plan a trained routing policy converges to: cruise to the
    # goal's (x, y) at a per-drone altitude band, then descend onto the
    # goal once overhead.
    task = dataclasses.replace(task, relative_actions=False)
    dests = torch.tensor(task.destinations, dtype=torch.float32,
                         device=device)
    # the band starts at a NONZERO offset so every drone — including drone
    # 0 — cruises above its goal altitude with its own band
    cruise = dests.clone()
    cruise[:, 2] += 0.15 * (torch.arange(num_drones, dtype=torch.float32,
                                         device=device) + 1.0)
    # no auto-reset: we want the final arrival snapshot, not episode cycling
    reset_fn, step_fn = make_batched_step(cfg, task, num_envs,
                                          autoreset=False, device=device)

    def rollout(n_steps):
        state, _ = reset_fn()
        descend = torch.zeros((num_envs, num_drones), dtype=torch.bool,
                              device=device)
        total = torch.zeros((), device=device)
        for _ in range(n_steps):
            pos = state.pos.reshape(num_envs, num_drones, 3)
            xy_err = torch.linalg.norm(pos[..., :2] - dests[None, :, :2],
                                       dim=-1)
            # latch the leg switch: once a drone has been overhead its goal
            # it keeps the descend command (a plain threshold chatters at
            # the boundary and destabilizes the PID)
            descend = descend | (xy_err < 0.15)
            action = torch.where(descend[..., None], dests[None],
                                 cruise[None])
            state, _, reward, _, _ = step_fn(state, action)
            total = total + reward.sum()
        return state, total

    n_steps = duration_sec * cfg.ctrl_freq
    rollout(1)                                 # warm-up: builds the kernel
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    state, total = rollout(n_steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    readback = float(total)
    seconds = time.perf_counter() - t0
    if not np.isfinite(readback):
        raise FloatingPointError("swarm: non-finite reward sum")
    # the fast-path carry is flattened (envs*drones, 3)
    err = torch.linalg.norm(state.pos - dests.repeat(num_envs, 1), dim=-1)
    arrived = float((err < 0.15).float().mean())
    return cfg, state, arrived, float(err.mean()), n_steps, seconds


def run(num_envs=4096, num_drones=4, duration_sec=8, render_frame=True,
        output_folder="results", device=None):
    cfg, state, arrived, mean_err, n_steps, dt = fly(
        num_envs, num_drones, duration_sec, device)
    total_drones = num_envs * num_drones
    print(f"[RESULT] {num_envs} envs x {num_drones} drones "
          f"({total_drones} drones) x {n_steps} ctrl steps in {dt:.2f}s "
          f"= {num_envs * n_steps / dt / 1e6:.2f}M env-steps/s "
          f"({total_drones * n_steps * cfg.steps_per_ctrl / dt / 1e6:.0f}M "
          f"drone-substeps/s)")
    print(f"[RESULT] mean goal error {mean_err:.3f} m; "
          f"{arrived * 100:.1f}% of drones within 15 cm "
          f"after {duration_sec}s sim time")

    if render_frame:
        from gym_pybullet_drones_tpu_torch.ops import render
        Image = require("PIL.Image", "swarm's rendered frame")
        eye = np.array([3.0, -2.0, 2.0], np.float32)
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        rot = np.stack([fwd, -right, up], axis=-1).astype(np.float32)
        dev = state.pos.device
        rgba, _, _ = render.render(
            cfg.drone, render.empty_scene(), torch.as_tensor(eye, device=dev),
            torch.as_tensor(rot, device=dev),
            drone_pos=state.pos[:num_drones], width=320, height=240)
        os.makedirs(output_folder, exist_ok=True)
        out = f"{output_folder}/swarm_frame.png"
        Image.fromarray(rgba.cpu().numpy().astype("uint8"), "RGBA").save(out)
        print(f"[RESULT] rendered fleet 0 to {out}")
    return arrived


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Batched swarm showcase")
    parser.add_argument("--num_envs", default=4096, type=int, metavar="")
    parser.add_argument("--num_drones", default=4, type=int, metavar="")
    parser.add_argument("--duration_sec", default=8, type=int, metavar="")
    parser.add_argument("--render_frame", default=True, type=str2bool,
                        metavar="")
    parser.add_argument("--output_folder", default="results", type=str,
                        metavar="")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: the CUDA card)",
                        metavar="")
    ARGS = parser.parse_args()
    run(**vars(ARGS))
