"""Environments: functional core, task layer, fast batched stepping."""
from gym_pybullet_drones_tpu_torch.envs.core import (  # noqa: F401
    AviaryConfig,
    EnvState,
    adjacency_matrix,
    next_waypoint,
    normalized_action_to_rpm,
    reset,
    state_vector,
    step,
    step_autoreset,
)
from gym_pybullet_drones_tpu_torch.envs.tasks import (  # noqa: F401
    CtrlTask,
    HoverTask,
    MultiHoverTask,
    RLTask,
    VelocityTask,
)
from gym_pybullet_drones_tpu_torch.envs.routing import (  # noqa: F401
    RoutingTask,
    make_routing_config,
)
from gym_pybullet_drones_tpu_torch.envs.fast import (  # noqa: F401
    fused_spec,
    make_batched_step,
    make_fused_rollout,
)
