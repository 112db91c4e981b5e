"""Enumerations mirroring the reference API surface.

Parity target: the reference gym_pybullet_drones/utils/enums.py:3-48
(DroneModel, Physics, ImageType, ActionType, ObservationType).
"""
from enum import Enum, IntEnum


class DroneModel(Enum):
    """Drone models with parameter tables in `gym_pybullet_drones_tpu_torch.params`."""

    CF2X = "cf2x"  # Bitcraze Crazyflie 2.0, X configuration
    CF2P = "cf2p"  # Bitcraze Crazyflie 2.0, + configuration
    RACE = "racer"  # Racing drone


class Physics(Enum):
    """Physics implementations (same six modes as the reference engine)."""

    PYB = "pyb"  # Rigid-body integrator with ground contact
    DYN = "dyn"  # Explicit dynamics (the bit-parity target mode)
    PYB_GND = "pyb_gnd"  # PYB + ground effect
    PYB_DRAG = "pyb_drag"  # PYB + rotor drag
    PYB_DW = "pyb_dw"  # PYB + downwash
    PYB_GND_DRAG_DW = "pyb_gnd_drag_dw"  # PYB + all aero effects


class PhysicsCode(IntEnum):
    """Static integer codes for Physics used inside compiled kernels."""

    PYB = 0
    DYN = 1
    PYB_GND = 2
    PYB_DRAG = 3
    PYB_DW = 4
    PYB_GND_DRAG_DW = 5


PHYSICS_TO_CODE = {
    Physics.PYB: PhysicsCode.PYB,
    Physics.DYN: PhysicsCode.DYN,
    Physics.PYB_GND: PhysicsCode.PYB_GND,
    Physics.PYB_DRAG: PhysicsCode.PYB_DRAG,
    Physics.PYB_DW: PhysicsCode.PYB_DW,
    Physics.PYB_GND_DRAG_DW: PhysicsCode.PYB_GND_DRAG_DW,
}


class ImageType(IntEnum):
    """Camera capture types."""

    RGB = 0
    DEP = 1
    SEG = 2
    BW = 3


class ActionType(Enum):
    """Action types for the RL aviaries."""

    RPM = "rpm"
    PID = "pid"
    VEL = "vel"
    ONE_D_RPM = "one_d_rpm"
    ONE_D_PID = "one_d_pid"


class ObservationType(Enum):
    """Observation types for the RL aviaries."""

    KIN = "kin"
    RGB = "rgb"
