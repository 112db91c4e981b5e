"""Controllers: the DSL cascaded PID of the Crazyflie, CTBR, and the
firmware-style Mellinger / PID with the high-level commander."""
from gym_pybullet_drones_tpu_torch.control.dsl_pid import (  # noqa: F401
    DSLPIDControl,
    PIDState,
    compute_control,
    compute_control_from_state,
    init_state,
    one23d_interface,
)
from gym_pybullet_drones_tpu_torch.control.ctbr import (  # noqa: F401
    CTBRControl,
    compute_ctbr,
)
from gym_pybullet_drones_tpu_torch.control import firmware  # noqa: F401
from gym_pybullet_drones_tpu_torch.control import firmware_pid  # noqa: F401
from gym_pybullet_drones_tpu_torch.control.commander import (  # noqa: F401
    HighLevelCommander,
)
