"""Checkpoint/resume of a training run (env + policy + optimizer + draws).

Counterpart of the JAX package's `utils/checkpoint.py`.  One file holds the
complete state of a `rl.ppo.TrainState`: the policy's state dict, Adam's
moments and step count, the env carry (the fused (RC, E) block or the
flat `EnvState`'s leaves), the last obs, the training generator's state,
the update counter and, for a task with reset noise, the position of the
env's reset-noise stream (`TrainState.reset_noise`, where the JAX
package's env state carries its key); training resumes from it bit for
bit.  Only
tensors, lists, dicts and numbers are written, so it loads with
`torch.load(..., weights_only=True)`.  The sharded case of the JAX package
(an env batch over a device mesh) is not ported (ROADMAP.md queue 1, item
16).
"""
from __future__ import annotations

import os

import torch

from gym_pybullet_drones_tpu_torch.envs.core import leaves, map_leaves
from gym_pybullet_drones_tpu_torch.rl.ppo import AdamState, TrainState


def save_checkpoint(path: str, train_state: TrainState,
                    step: int | None = None) -> str:
    """Write the full TrainState to one file; returns its path
    (`path/step_<step>.pt` when `step` is given)."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ts = train_state
    payload = {
        "network": ts.network.state_dict(),
        "count": int(ts.opt_state.count),
        "mu": list(ts.opt_state.mu), "nu": list(ts.opt_state.nu),
        "env_state": leaves(ts.env_state),
        "last_obs": ts.last_obs,
        "generator": ts.generator.get_state(),
        "update_idx": int(ts.update_idx),
        "reset_noise": None if ts.reset_noise is None
        else ts.reset_noise.get_state(),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Restore a checkpoint into `target`, a fresh `init(...)` TrainState of
    the same run configuration: its module takes the saved weights and
    its generator and its reset-noise stream the saved states; every other
    tensor is the file's, moved to the target's device.  Returns the
    restored TrainState."""
    device = target.last_obs.device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    target.network.load_state_dict(ckpt["network"])
    saved = ckpt["env_state"]
    if [(x.shape, x.dtype) for x in saved] != [
            (x.shape, x.dtype) for x in leaves(target.env_state)]:
        raise ValueError(f"{path}: the env carry does not fit the target's")
    if (ckpt["reset_noise"] is None) != (target.reset_noise is None):
        raise ValueError(f"{path}: the reset noise does not fit the "
                         "target's task")
    saved_leaves = iter(saved)
    env_state = map_leaves(lambda _: next(saved_leaves), target.env_state)
    if target.reset_noise is not None:
        target.reset_noise.set_state(ckpt["reset_noise"])
    # a generator's state is a CPU byte tensor, whatever its device
    target.generator.set_state(ckpt["generator"].cpu())
    return target._replace(
        opt_state=AdamState(ckpt["count"], ckpt["mu"], ckpt["nu"]),
        env_state=env_state, last_obs=ckpt["last_obs"],
        update_idx=ckpt["update_idx"])
