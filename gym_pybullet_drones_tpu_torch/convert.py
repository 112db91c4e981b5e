"""State carried across from the JAX package, as numpy arrays.

Both packages can be started from the same mid-rollout state: the JAX
side's `EnvState` leaves and packed fused carry are handed over as numpy
arrays and become this package's tensors, and back.  Nothing here imports
the JAX package; the caller does the `np.asarray`.

There are no network weights yet; the PPO port extends this module with
the MLP's parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.envs.core import EnvState
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device

LANE = 128  # the JAX package pads the fused carry's env axis to this


def env_state_from_numpy(leaves: dict, device=None) -> EnvState:
    """JAX `EnvState` leaves {field: array} -> this package's EnvState.

    Shapes are kept (per-env (N, k), batched, or the flat (B*N, k) carry);
    the JAX-only leaves (`ctrl_state`, `rng`) are ignored.  Float leaves
    keep their dtype, the step counter becomes int32.
    """
    device = resolve_device(device)
    conv = lambda k: torch.tensor(np.asarray(leaves[k]), device=device)
    fields = {k: conv(k) for k in EnvState._fields if k != "step_counter"}
    return EnvState(step_counter=conv("step_counter").to(torch.int32),
                    **fields)


def env_state_to_numpy(state: EnvState) -> dict:
    """This package's EnvState -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def fused_carry_from_numpy(carry: np.ndarray, num_envs: int,
                           device=None) -> torch.Tensor:
    """JAX packed fused carry (RC, Bp), Bp = num_envs padded to 128 lanes
    -> this package's (RC, num_envs) float32 carry (padding dropped)."""
    device = resolve_device(device)
    return torch.tensor(np.asarray(carry, np.float32)[:, :num_envs],
                        device=device)


def fused_carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    """This package's (RC, B) carry -> the JAX package's (RC, Bp) numpy
    block, env axis zero-padded to a multiple of 128 lanes."""
    blk = carry.detach().cpu().numpy()
    pad = (-blk.shape[1]) % LANE
    return np.pad(blk, ((0, 0), (0, pad)))
