"""Environments: functional core, task layer, fast batched stepping."""
from gym_pybullet_drones_tpu_torch.envs.core import (  # noqa: F401
    AviaryConfig,
    EnvState,
    reset,
    state_vector,
    step,
    step_autoreset,
)
from gym_pybullet_drones_tpu_torch.envs.tasks import (  # noqa: F401
    HoverTask,
    MultiHoverTask,
    RLTask,
)
from gym_pybullet_drones_tpu_torch.envs.fast import (  # noqa: F401
    fused_spec,
    make_batched_step,
    make_fused_rollout,
)
