"""Controllers: the DSL cascaded PID of the Crazyflie."""
from gym_pybullet_drones_tpu_torch.control.dsl_pid import (  # noqa: F401
    DSLPIDControl,
    PIDState,
    compute_control,
    compute_control_from_state,
    init_state,
    one23d_interface,
)
