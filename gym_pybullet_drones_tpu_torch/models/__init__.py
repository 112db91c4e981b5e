"""Policy networks."""
from gym_pybullet_drones_tpu_torch.models.cnn import (  # noqa: F401
    ActorCriticCNN,
    PopulationActorCriticCNN,
)
from gym_pybullet_drones_tpu_torch.models.mlp import (  # noqa: F401
    ActorCritic,
    PopulationActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)
