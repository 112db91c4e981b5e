"""Policy networks."""
from gym_pybullet_drones_tpu_torch.models.mlp import (  # noqa: F401
    ActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)
