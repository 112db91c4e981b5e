"""Environments: functional core, task layer, fast batched stepping, class
adapters, and the firmware-in-the-loop and SITL aviaries."""
from gym_pybullet_drones_tpu_torch.envs.core import (  # noqa: F401
    AviaryConfig,
    EnvState,
    adjacency_matrix,
    has_reset_noise,
    initial_state,
    next_waypoint,
    normalized_action_to_rpm,
    reset,
    reset_draws,
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
    ResetNoise,
    fused_spec,
    make_batched_step,
    make_fused_rollout,
)
from gym_pybullet_drones_tpu_torch.envs.gym_adapter import (  # noqa: F401
    OBSTACLE_SPHERES,
    BatchedEnv,
    CtrlAviary,
    FunctionalAviary,
    HoverAviary,
    MultiHoverAviary,
    VelocityAviary,
)
from gym_pybullet_drones_tpu_torch.envs.cf_aviary import CFAviary  # noqa: F401
from gym_pybullet_drones_tpu_torch.envs.beta_aviary import BetaAviary  # noqa: F401
from gym_pybullet_drones_tpu_torch.envs.spaces import Box  # noqa: F401
