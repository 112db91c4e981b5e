"""Compute kernels: quaternion math, explicit dynamics, the CUDA kernels'
wrappers and plain versions."""
from gym_pybullet_drones_tpu_torch.ops import (  # noqa: F401
    quat, dynamics, kernel_math, kernel_dyn, kernel_pid, kernel_fused)
