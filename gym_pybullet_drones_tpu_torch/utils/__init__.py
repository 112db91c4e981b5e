"""Utilities: enums and device resolution."""
from gym_pybullet_drones_tpu_torch.utils.enums import (  # noqa: F401
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device  # noqa: F401
