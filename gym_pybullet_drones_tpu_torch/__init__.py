"""gym-pybullet-drones-tpu, PyTorch/CUDA port.

A second package beside `gym_pybullet_drones_tpu` (the JAX reference, of
which it imports nothing): the same batched quadrotor environments on one
NVIDIA Hopper GPU, with plain tensor code in PyTorch and every kernel the
JAX package wrote for the TPU written by hand in CUDA C++ (`csrc/`, built
at first use by `_build.py`).

Ported so far: the batched rollout path — `envs.fast.make_fused_rollout`
and `envs.fast.make_batched_step` — and `envs.core.step` for HoverTask,
MultiHoverTask and the routing fleet, every action type, every physics mode
(DYN and the PYB family with its contacts and aero effects), randomized
resets, PPO and population training, RGB observations, the class adapters
(`envs.gym_adapter`: CtrlAviary, VelocityAviary, HoverAviary,
MultiHoverAviary, BatchedEnv) and the examples, and what they stand on.
ROADMAP.md lists what is still to port.  No Gymnasium ids are registered:
the port does without gymnasium.

Every entry point takes a `device`; None means the CUDA card and raises
where there is none.
"""
__version__ = "0.1.0"

from gym_pybullet_drones_tpu_torch.params import CF2X, CF2P, RACE, get_params  # noqa: F401
from gym_pybullet_drones_tpu_torch.utils.enums import (  # noqa: F401
    ActionType,
    DroneModel,
    ObservationType,
    Physics,
)
