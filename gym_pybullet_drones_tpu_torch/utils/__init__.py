"""Utilities: enums, device resolution, and the host-side helpers of the
examples and the class adapters (logger, viewer, video, pacing)."""
from gym_pybullet_drones_tpu_torch.utils.enums import (  # noqa: F401
    ActionType,
    DroneModel,
    ImageType,
    ObservationType,
    Physics,
)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device  # noqa: F401
