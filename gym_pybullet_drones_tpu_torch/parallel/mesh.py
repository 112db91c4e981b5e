"""Data-parallel training over ranks: the mesh, and a TrainState on it.

Counterpart of the JAX package's `parallel/mesh.py`.  There, one mesh
axis "data" splits the env batch over devices, the policy and the
optimizer state are replicated, and GSPMD inserts the collectives.  Here
one process is one rank of a `torch.distributed` group (`initialize`), a
`Mesh` names the group, this rank and its device, and the trainer calls
the collectives itself: rank r owns env columns [r*E/R, (r+1)*E/R) of the
global batch and steps them with its own kernel launches on its own
device; the policy and Adam's moments are replicated; one update
all-reduces the advantage statistics and the gradient of every optimizer
step, and its metrics (`rl/ppo.py` `make_update`).  A sharded update
computes what one process computes on the global batch, up to the order
of the reductions.

Every collective is an `all_reduce` or a `broadcast` (all that gloo runs
on CUDA tensors) and goes through the mesh, which counts them and their
bytes (`Mesh.collectives`, `Mesh.collective_bytes`) and wraps each in a
span (`mesh.all_reduce`, `mesh.broadcast`, with the attribute `bytes`;
`utils.profiling.span`).  Kernels launch on the current stream, which the
collectives wait on.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from gym_pybullet_drones_tpu_torch.envs.core import map_leaves
from gym_pybullet_drones_tpu_torch.envs.fast import ResetNoise
from gym_pybullet_drones_tpu_torch.parallel.distributed import (
    _env_int, check_backend, global_env_batch, local_env_batch)
from gym_pybullet_drones_tpu_torch.utils.profiling import span


class Mesh:
    """One "data" axis of `size` ranks of the default group: this
    process's `rank`, its `device` and the group's `backend` (None for a
    single process, which forms no group).  A one-rank mesh skips every
    collective."""

    axis_name = "data"

    def __init__(self, rank: int, size: int, device, backend=None):
        self.rank, self.size = rank, size
        self.device = torch.device(device)
        self.backend = backend
        self.collectives = 0      # collectives this rank entered
        self.collective_bytes = 0  # the bytes of the tensors it entered

    def env_range(self, num_envs: int) -> tuple:
        """(lo, hi): this rank's columns of a global batch of `num_envs`;
        refuses a batch that the ranks cannot split evenly."""
        if num_envs % self.size:
            raise ValueError(f"num_envs={num_envs} must divide evenly over "
                             f"the mesh's {self.size} ranks")
        per = num_envs // self.size
        return self.rank * per, (self.rank + 1) * per

    def _entered(self, x: torch.Tensor) -> int:
        nbytes = x.numel() * x.element_size()
        self.collectives += 1
        self.collective_bytes += nbytes
        return nbytes

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum `x` over the ranks, in place; returns it."""
        if self.size > 1:
            with span("mesh.all_reduce", bytes=self._entered(x)):
                dist.all_reduce(x)
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank `src`'s `x` on every rank, in place; returns it."""
        if self.size > 1:
            with span("mesh.broadcast", bytes=self._entered(x)):
                dist.broadcast(x, src)
        return x


def make_mesh(backend: str | None = None, device=None) -> Mesh:
    """The mesh of the initialized group (`initialize`), or of this one
    process where none was formed.

    `backend`, if given, must be the group's.  `device`: None means this
    rank's card: `cuda:{LOCAL_RANK}` under NCCL (one card a rank), the
    current card under gloo (ranks may share it); without CUDA it raises,
    as `utils.device.resolve_device` does.  The tests pass "cpu" (gloo).
    """
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        group_backend = dist.get_backend()
        if backend is not None and backend != group_backend:
            raise ValueError(f"the group runs {group_backend}, not "
                             f"{backend}")
        backend = group_backend
        check_backend(backend, size)
    else:
        rank, size = 0, 1
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the host")
        if backend == "nccl":
            local = _env_int("LOCAL_RANK")
            device = torch.device("cuda", rank % torch.cuda.device_count()
                                  if local is None else local)
        else:
            device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on cards, not on {device}")
        torch.cuda.set_device(device)
    return Mesh(rank, size, device, backend)


def carry_axis(env_state) -> int:
    """The env axis of an env carry: 1 for the fused (rows, envs) block,
    0 for the flat EnvState's env-major leaves."""
    return 1 if isinstance(env_state, torch.Tensor) else 0


def _noise_on(noise: ResetNoise, device, rows, block) -> ResetNoise:
    """A copy of stream `noise` at its position, with `rows` (None: all)
    and `block` (that many rows of the current block)."""
    state = noise.get_state()
    state["block"] = block
    out = ResetNoise(0, noise.shape, device, rows)
    out.set_state(state)
    return out


def shard_train_state(ts, mesh: Mesh):
    """This rank's part of a global `rl.ppo.TrainState` (one process's
    `init`, a population's `pop_init`): its env columns, last obs and rows
    of the reset-noise stream; the policy, Adam's moments and the
    generator replicated, on the mesh's device.  It is the shard that
    `make_train(..., mesh=mesh)`'s `init` builds without the global
    batch."""
    axis = carry_axis(ts.env_state)
    env_state = map_leaves(lambda x: local_env_batch(mesh, x, axis),
                           ts.env_state)
    noise = ts.reset_noise
    if noise is not None:
        if noise.rows != (0, noise.shape[0]):
            raise ValueError("the TrainState's reset noise is sharded "
                             "already")
        lo, hi = mesh.env_range(noise.shape[0])
        noise = _noise_on(noise, mesh.device, (lo, hi), None
                          if noise.block is None else noise.block[:, lo:hi])
    move = lambda xs: [x.to(mesh.device) for x in xs]
    return ts._replace(
        network=ts.network.to(mesh.device),
        opt_state=ts.opt_state._replace(mu=move(ts.opt_state.mu),
                                        nu=move(ts.opt_state.nu)),
        env_state=env_state, last_obs=local_env_batch(mesh, ts.last_obs),
        reset_noise=noise)


def gather_train_state(ts, mesh: Mesh):
    """The global TrainState of a sharded one, on every rank, bit for bit
    (`global_env_batch`): what one process holds at the same point."""
    if mesh.size == 1:
        return ts
    axis = carry_axis(ts.env_state)
    env_state = map_leaves(lambda x: global_env_batch(mesh, x, axis),
                           ts.env_state)
    noise = ts.reset_noise
    if noise is not None:
        noise = _noise_on(noise, mesh.device, None, None
                          if noise.block is None
                          else global_env_batch(mesh, noise.block, 1))
    return ts._replace(env_state=env_state,
                       last_obs=global_env_batch(mesh, ts.last_obs),
                       reset_noise=noise)


def make_sharded_update(update, mesh: Mesh):
    """The update of `make_train(..., mesh=mesh)`, checked to be built for
    this mesh; it takes that `init`'s shard of the TrainState.  (The JAX
    package jits the update here; a rank's update is eager.)"""
    if getattr(update, "mesh", None) is not mesh:
        raise ValueError("this update was not built for this mesh: pass "
                         "mesh= to make_train")
    return update
