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
`torch.load(..., weights_only=True)`.

A TrainState sharded over a `parallel.Mesh` is saved as the global state
it is part of: the ranks' env columns are gathered, and rank 0 writes the
same file that one process writes at the same point.  It restores onto
any mesh whose size divides the env batch, one process included, each
rank taking its columns, and training resumes bit for bit.
"""
from __future__ import annotations

import os

import torch

from gym_pybullet_drones_tpu_torch.envs.core import leaves, map_leaves
from gym_pybullet_drones_tpu_torch.parallel.distributed import (
    local_env_batch)
from gym_pybullet_drones_tpu_torch.parallel.mesh import (
    carry_axis, gather_train_state)
from gym_pybullet_drones_tpu_torch.rl.ppo import AdamState, TrainState


def save_checkpoint(path: str, train_state: TrainState,
                    step: int | None = None, mesh=None) -> str:
    """Write the full TrainState to one file; returns its path
    (`path/step_<step>.pt` when `step` is given).  Under `mesh`, every
    rank calls it with its shard: the global state is gathered, rank 0
    writes it, and no rank returns before the file is in place."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}.pt")
    ts = train_state if mesh is None \
        else gather_train_state(train_state, mesh)
    if mesh is None or mesh.rank == 0:
        _write(path, ts)
    if mesh is not None:
        # a barrier (all_reduce and broadcast are what gloo runs on CUDA)
        mesh.all_reduce(torch.zeros(1, device=mesh.device))
    return path


def _write(path: str, ts: TrainState) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
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


def restore_checkpoint(path: str, target: TrainState,
                       mesh=None) -> TrainState:
    """Restore a checkpoint into `target`, a fresh `init(...)` TrainState of
    the same run configuration: its module takes the saved weights and
    its generator and its reset-noise stream the saved states; every other
    tensor is the file's, moved to the target's device.  Returns the
    restored TrainState.  Under `mesh`, `target` is this rank's shard
    (`make_train(..., mesh=mesh)`'s `init`) and takes its env columns of
    the file's global state, whatever number of ranks wrote it."""
    device = target.last_obs.device
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    # this rank's columns (all of them without a mesh), on the device
    cut = (lambda x, axis=0: x.to(device)) if mesh is None \
        else (lambda x, axis=0: local_env_batch(mesh, x, axis))
    axis = carry_axis(target.env_state)
    saved = [cut(x, axis) for x in ckpt["env_state"]]
    if [(x.shape, x.dtype) for x in saved] != [
            (x.shape, x.dtype) for x in leaves(target.env_state)]:
        raise ValueError(f"{path}: the env carry does not fit the target's")
    if (ckpt["reset_noise"] is None) != (target.reset_noise is None):
        raise ValueError(f"{path}: the reset noise does not fit the "
                         "target's task")
    target.network.load_state_dict(ckpt["network"])
    saved_leaves = iter(saved)
    env_state = map_leaves(lambda _: next(saved_leaves), target.env_state)
    noise = ckpt["reset_noise"]
    if noise is not None:
        lo, hi = target.reset_noise.rows
        block = noise["block"]
        target.reset_noise.set_state(dict(
            noise, block=None if block is None else block[:, lo:hi]))
    # a generator's state is a CPU byte tensor, whatever its device
    target.generator.set_state(ckpt["generator"].cpu())
    move = lambda xs: [x.to(device) for x in xs]
    return target._replace(
        opt_state=AdamState(ckpt["count"], move(ckpt["mu"]),
                            move(ckpt["nu"])),
        env_state=env_state, last_obs=cut(ckpt["last_obs"]),
        update_idx=ckpt["update_idx"])
