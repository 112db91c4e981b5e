"""ctypes bindings for the C++ Crazyflie firmware oracle.

Counterpart of the JAX package's `native/firmware_oracle.py`, over the
port's own copy of `cf_firmware_oracle.cpp`: an independent C++
double-precision transcription of the firmware's filter, Mellinger
controller, PID cascade and power distribution, which plays the role of
pycffirmware.  `tests/test_torch_firmware_oracle.py` holds the port's
`control/firmware.py` and `control/firmware_pid.py` against it tick for
tick over takeoff-goto-land sequences, and `chip_smoke.py`'s `host_loops`
does so on the card's host.

Built like the package's other native sources (`native.build`): g++ at
first use into `build/native/`, hash-keyed; nothing at import time; a
failed build raises with the compiler's message.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from gym_pybullet_drones_tpu_torch.native import build

_DP = ctypes.POINTER(ctypes.c_double)


class _MellingerState(ctypes.Structure):
    _fields_ = [("i_error_pos", ctypes.c_double * 3),
                ("i_error_m", ctypes.c_double * 3),
                ("prev_omega", ctypes.c_double * 2)]


class _Pid1(ctypes.Structure):
    _fields_ = [("integ", ctypes.c_double), ("prev_e", ctypes.c_double)]


class _FwPidState(ctypes.Structure):
    _fields_ = [("vx", _Pid1), ("vy", _Pid1), ("vz", _Pid1),
                ("att_roll", _Pid1), ("att_pitch", _Pid1), ("att_yaw", _Pid1),
                ("rate_roll", _Pid1), ("rate_pitch", _Pid1),
                ("rate_yaw", _Pid1),
                ("des_roll", ctypes.c_double), ("des_pitch", ctypes.c_double),
                ("thrust", ctypes.c_double)]


class _Lpf2p(ctypes.Structure):
    _fields_ = [("b0", ctypes.c_double), ("b1", ctypes.c_double),
                ("b2", ctypes.c_double), ("a1", ctypes.c_double),
                ("a2", ctypes.c_double), ("d1", ctypes.c_double),
                ("d2", ctypes.c_double)]


@functools.cache
def _lib():
    lib = ctypes.CDLL(build("cf_firmware_oracle"))
    lib.lpf2p_init.argtypes = [ctypes.POINTER(_Lpf2p), ctypes.c_double,
                               ctypes.c_double]
    lib.lpf2p_init.restype = None
    lib.lpf2p_apply.argtypes = [ctypes.POINTER(_Lpf2p), ctypes.c_double]
    lib.lpf2p_apply.restype = ctypes.c_double
    lib.mellinger_init.argtypes = [ctypes.POINTER(_MellingerState)]
    lib.mellinger_init.restype = None
    lib.mellinger_tick.argtypes = [ctypes.POINTER(_MellingerState)] \
        + [_DP] * 9 + [ctypes.c_double, _DP]
    lib.mellinger_tick.restype = None
    lib.fwpid_init.argtypes = [ctypes.POINTER(_FwPidState)]
    lib.fwpid_init.restype = None
    lib.fwpid_position.argtypes = [ctypes.POINTER(_FwPidState),
                                   ctypes.c_double, _DP, _DP,
                                   ctypes.c_double, _DP]
    lib.fwpid_position.restype = None
    lib.fwpid_attitude.argtypes = [ctypes.POINTER(_FwPidState),
                                   ctypes.c_double, _DP, _DP,
                                   ctypes.c_double, _DP]
    lib.fwpid_attitude.restype = None
    lib.power_distribution.argtypes = [_DP, ctypes.c_int, _DP]
    lib.power_distribution.restype = None
    return lib


def available() -> bool:
    """True if g++ builds and loads the oracle on this host; False, not an
    exception, where it cannot (the JAX package's `available`)."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _vec(x, n):
    """A contiguous float64 copy of `x`, checked to hold `n` values: the
    oracle reads that many through the pointer."""
    a = np.ascontiguousarray(x, np.float64)
    if a.shape != (n,):
        raise ValueError(f"expected ({n},) values, got {a.shape}")
    return a


def _ptr(a):
    return a.ctypes.data_as(_DP)


class Lpf2pOracle:
    """The firmware's 2-pole Butterworth low-pass filter on one signal."""

    def __init__(self, sample_freq: float, cutoff_freq: float):
        self._lib = _lib()
        self._st = _Lpf2p()
        self._lib.lpf2p_init(ctypes.byref(self._st), sample_freq, cutoff_freq)

    def apply(self, sample: float) -> float:
        return self._lib.lpf2p_apply(ctypes.byref(self._st), float(sample))


class MellingerOracle:
    """Stateful Mellinger tick (controller_mellinger.c transcription)."""

    def __init__(self):
        self._lib = _lib()
        self._st = _MellingerState()
        self._lib.mellinger_init(ctypes.byref(self._st))

    def tick(self, sp_pos, sp_vel, sp_acc, sp_att_rate_deg, sp_quat,
             pos, vel, quat, gyro_deg, dt: float) -> np.ndarray:
        """One control tick -> control_t (thrust, roll, pitch, yaw), (4,);
        quaternions (x, y, z, w), rates in degrees a second."""
        out = np.zeros(4, np.float64)
        args = [_vec(a, n) for a, n in zip(
            (sp_pos, sp_vel, sp_acc, sp_att_rate_deg, sp_quat, pos, vel,
             quat, gyro_deg), (3, 3, 3, 3, 4, 3, 3, 4, 3))]
        self._lib.mellinger_tick(ctypes.byref(self._st),
                                 *[_ptr(a) for a in args],
                                 ctypes.c_double(dt), _ptr(out))
        return out


class FirmwarePidOracle:
    """Stateful PID-cascade tick (controller_pid.c transcription)."""

    def __init__(self):
        self._lib = _lib()
        self._st = _FwPidState()
        self._lib.fwpid_init(ctypes.byref(self._st))

    def position(self, dt, pos, vel, yaw_deg, target_pos):
        """One position-loop tick; updates the desired roll, pitch and
        thrust (`des_roll`, `des_pitch`, `thrust`)."""
        self._lib.fwpid_position(
            ctypes.byref(self._st), ctypes.c_double(dt), _ptr(_vec(pos, 3)),
            _ptr(_vec(vel, 3)), ctypes.c_double(yaw_deg),
            _ptr(_vec(target_pos, 3)))

    def attitude(self, dt, rpy_deg, gyro_deg, target_yaw_deg) -> np.ndarray:
        """One attitude-and-rate tick -> (thrust, roll, pitch, yaw)."""
        out = np.zeros(4, np.float64)
        self._lib.fwpid_attitude(
            ctypes.byref(self._st), ctypes.c_double(dt),
            _ptr(_vec(rpy_deg, 3)), _ptr(_vec(gyro_deg, 3)),
            ctypes.c_double(target_yaw_deg), _ptr(out))
        return out

    @property
    def des_roll(self) -> float:
        return self._st.des_roll

    @property
    def des_pitch(self) -> float:
        return self._st.des_pitch

    @property
    def thrust(self) -> float:
        return self._st.thrust


def power_distribution(control, quad_formation_x: bool = True) -> np.ndarray:
    """control_t (thrust, roll, pitch, yaw) -> the four motors' PWM."""
    out = np.zeros(4, np.float64)
    _lib().power_distribution(_ptr(_vec(control, 4)),
                              1 if quad_formation_x else 0, _ptr(out))
    return out
