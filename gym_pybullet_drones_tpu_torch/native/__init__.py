"""Native (C++) host components, built with g++ and bound through ctypes.

Counterpart of the JAX package's `native/__init__.py`, with the port's own
copies of its three sources:

- `dynamics_oracle.cpp` (`dyn_rollout`): an independent C++
  double-precision implementation of the DYN physics contract, to
  cross-check the physics from outside Python;
- `sitl_bridge.cpp` (`SitlBridge`): the Betaflight SITL UDP bridge of
  `envs.beta_aviary.BetaAviary(use_native_bridge=True)`, one C call per
  drone and tick;
- `cf_firmware_oracle.cpp` (`native.firmware_oracle`): an independent C++
  double-precision transcription of the Crazyflie firmware's controllers,
  the stand-in for pycffirmware that the port's firmware is held against.

These are host components: g++ builds them, not nvcc.  Nothing is built at
import time; the first use builds a source into `build/native/` next to
the package, named by a hash of the source and the flags (an edited
source is rebuilt, an unchanged one reused), as `_build.py` does for the
CUDA kernels.  A failed build raises with the compiler's message: there
is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_MODEL_CODE = {"cf2x": 0, "cf2p": 1, "racer": 2}
_DP = ctypes.POINTER(ctypes.c_double)


def build_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(NATIVE_DIR)),
                        "build", "native")


def build(name: str) -> str:
    """Compile `<name>.cpp` unless built already; return the library's
    path."""
    src = os.path.join(NATIVE_DIR, f"{name}.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha256(" ".join(GXX_FLAGS).encode() + f.read()) \
            .hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    if os.path.isfile(lib):
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{name}.cpp cannot be "
                           "built")
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name} ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent processes may build too
    return lib


@functools.cache
def _oracle_lib():
    lib = ctypes.CDLL(build("dynamics_oracle"))
    lib.dyn_rollout.argtypes = [
        _DP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        _DP, _DP, _DP, _DP, _DP, _DP, _DP]
    lib.dyn_rollout.restype = None
    return lib


def available() -> bool:
    """True if g++ builds and loads the DYN oracle on this host; False, not
    an exception, where it cannot (the JAX package's `native.available`).
    """
    try:
        _oracle_lib()
    except (RuntimeError, OSError):
        return False
    return True


@functools.cache
def _bridge_lib():
    lib = ctypes.CDLL(build("sitl_bridge"))
    lib.sitl_bridge_create.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.sitl_bridge_create.restype = ctypes.c_void_p
    lib.sitl_bridge_tick.argtypes = [
        ctypes.c_void_p, ctypes.c_double, _DP,
        ctypes.POINTER(ctypes.c_ushort), ctypes.POINTER(ctypes.c_float)]
    lib.sitl_bridge_tick.restype = ctypes.c_int
    lib.sitl_bridge_destroy.argtypes = [ctypes.c_void_p]
    lib.sitl_bridge_destroy.restype = None
    return lib


def dyn_rollout(params, pos, quat, vel, rpy_rates, rpms, dt,
                return_traj: bool = False):
    """Native rollout of the explicit dynamics.

    params: DroneParams; state arrays (B, dim) float64; rpms (T, B, 4).
    Returns dict of final state arrays (+ 'traj' (T, B, 3) if requested).
    """
    lib = _oracle_lib()
    p = np.ascontiguousarray(
        [params.m, params.l, params.kf, params.km, params.ixx, params.iyy,
         params.izz], dtype=np.float64)
    pos = np.array(pos, np.float64, order="C")
    quat = np.array(quat, np.float64, order="C")
    vel = np.array(vel, np.float64, order="C")
    rates = np.array(rpy_rates, np.float64, order="C")
    rpms = np.ascontiguousarray(rpms, np.float64)
    B, T = pos.shape[0], rpms.shape[0]
    for name, a, cols in (("pos", pos, 3), ("quat", quat, 4),
                          ("vel", vel, 3), ("rpy_rates", rates, 3)):
        if a.shape != (B, cols):
            raise ValueError(f"{name} must be ({B}, {cols}), got {a.shape}")
    if rpms.shape != (T, B, 4):
        raise ValueError(f"rpms must be ({T}, {B}, 4), got {rpms.shape}")
    ang_v = np.zeros_like(pos)
    traj = np.zeros((T, B, 3)) if return_traj else None
    as_ptr = lambda a: a.ctypes.data_as(_DP)
    lib.dyn_rollout(
        as_ptr(p), _MODEL_CODE[params.model.value], B, T,
        ctypes.c_double(dt), as_ptr(pos), as_ptr(quat), as_ptr(vel),
        as_ptr(rates), as_ptr(ang_v), as_ptr(rpms),
        as_ptr(traj) if return_traj else None)
    out = {"pos": pos, "quat": quat, "vel": vel, "rpy_rates": rates,
           "ang_v": ang_v}
    if return_traj:
        out["traj"] = traj
    return out


class SitlBridge:
    """Native per-drone UDP bridge to a Betaflight SITL process.

    Binds the PWM port 9002 + 10 * index on `ip` and sends the FDM and RC
    packets to ports 9003 / 9004 + 10 * index there.  One `tick()` sends
    both packets and polls the PWMs in a single C call.
    """

    _handle = None

    def __init__(self, ip: str = "127.0.0.1", index: int = 0):
        self._lib = _bridge_lib()
        self._handle = self._lib.sitl_bridge_create(ip.encode(), index)
        if not self._handle:
            raise OSError(f"sitl_bridge_create failed: port "
                          f"{9002 + 10 * index} on {ip} in use?")
        self._pwm = np.zeros(4, np.float32)

    def tick(self, t: float, w_body, rc_channels):
        """Send state/RC for time t; returns (fresh: bool, pwm: (4,))."""
        w = np.ascontiguousarray(w_body, np.float64)
        rc = np.ascontiguousarray(rc_channels, np.uint16)
        if w.shape != (3,) or rc.shape != (16,):
            raise ValueError(f"w_body (3,) and rc_channels (16,) expected, "
                             f"got {w.shape} and {rc.shape}")
        if not self._handle:
            raise ValueError("the bridge is closed")
        res = self._lib.sitl_bridge_tick(
            self._handle, ctypes.c_double(t), w.ctypes.data_as(_DP),
            rc.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)),
            self._pwm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return res == 1, self._pwm.copy()

    def close(self):
        if self._handle:
            self._lib.sitl_bridge_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
