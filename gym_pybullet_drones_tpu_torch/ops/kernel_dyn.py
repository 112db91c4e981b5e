"""CUDA kernel: one DYN control step (all substeps) per launch.

Replaces the TPU kernel `gym_pybullet_drones_tpu/ops/pallas_dyn.py:
dyn_ctrl_step` (body `_kernel`, `_motor_mix`, `_dyn_substeps`).  Source:
`csrc/dyn_ctrl_step.cu`, device functions in `csrc/drone_kernels.cuh`.

State is packed component-per-row, column-per-(env x drone) as a (16, B)
block:

    0..2  pos xyz      3..6  quat xyzw      7..9  vel xyz
   10..12 body rpy-rates xyz               13..15 world ang_v xyz

What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; `PERF.md`):
neither its bytes nor its operations at the rollout's widths.  The bound
is 0.2-0.9 us at 4096-16384 columns; the launch costs 3.5-3.9 us, and one
warp (32 columns) costs within 13% of 4096 or 16384 columns: columns start
to cost only towards 65536, where the bytes (3.5 us) come near.  Of one
warp's time about 1.0-1.3 us is the launch floor (one dependent node of a
CUDA graph), the rest one memory round trip and one thread's dependent
chain: eight substeps, each waiting in program order on an IEEE
reciprocal, a square root, a sine/cosine argument reduction and a
division, every one of them a branch region around its slow path, which
the compiler does not schedule across.

The design therefore keeps the whole control step in one launch with one
thread per column, the drone's state in registers for all substeps, and
every row load and store coalesced (the column index is the contiguous
one), and shortens the chain without changing a result: `sincosf` takes
one argument reduction for both values (bit for bit `sinf`'s and
`cosf`'s), and the square root never sees 0 (`sqrtf(0)` takes the slow
path, and a warp with one column at rest would wait on it at every
substep).  The substep loop stays rolled: unrolling it was measured no
faster here and up to 10% slower in `pid_dyn_ctrl_step` (the longer body's
instruction fetch, with one warp per scheduler).  64 threads a block (32,
64 and 128 are within 2.5%).  There is no lane padding and no blocking by
fast-memory size: the kernel takes B and the row stride and masks its tail
threads.  Drone constants, substep count and dt arrive in a by-value
struct, so one build serves every configuration.

Semantics match `ops/dynamics.dyn_step` (reference BaseAviary.py:815-889)
including the stale-rotation ang_v store and the zero-omega quaternion
branch, at float32.

`dyn_ctrl_step_plain` is the same row arithmetic in plain PyTorch.  The
wrapper uses it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.params import DroneParams
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel
from gym_pybullet_drones_tpu_torch.ops import kernel_math
from gym_pybullet_drones_tpu_torch.utils import graphs
from gym_pybullet_drones_tpu_torch.utils.profiling import span

S = 16  # state rows per column

launches = 0  # kernel launches made by `dyn_ctrl_step_rows` (CUDA only)


def _mix_consts(params: DroneParams):
    """(signed km, arm coefficient, plus-configuration?) of the mixer."""
    km_s = -params.km if params.model == DroneModel.RACE else params.km
    if params.model == DroneModel.CF2P:
        return km_s, params.kf * params.l, True
    return km_s, params.kf * params.l / math.sqrt(2), False


def motor_mix_rows(params: DroneParams, r0, r1, r2, r3):
    """Per-motor rpm rows -> (total thrust, x/y/z torques) rows.

    Torques are sums of FACTORED squared-rpm differences, as in the float32
    branch of `ops/dynamics.motor_forces_torques`: (a-b)*(a+b) cancels
    exactly for bitwise-equal rpms whatever the compiler contracts into
    FMAs, so a symmetric hover stays symmetric.
    """
    kf = params.kf
    km_s, k_arm, plus = _mix_consts(params)
    f0, f1, f2, f3 = (r * r * kf for r in (r0, r1, r2, r3))
    thrust = f0 + f1 + f2 + f3
    dsq = lambda a, b: (a - b) * (a + b)
    z_torque = (dsq(r1, r0) + dsq(r3, r2)) * km_s
    if plus:
        x_torque = dsq(r1, r3) * k_arm
        y_torque = dsq(r2, r0) * k_arm
    else:
        x_torque = (dsq(r0, r2) + dsq(r1, r3)) * k_arm
        y_torque = (dsq(r1, r0) + dsq(r2, r3)) * k_arm
    return thrust, x_torque, y_torque, z_torque


def dyn_substeps_rows(params: DroneParams, n_substeps: int, dt: float,
                      state_rows, thrust, x_torque, y_torque, z_torque):
    """Run n explicit-dynamics substeps on (B,) row tensors.

    state_rows = (px..pz, qx..qw, vx..vz, wx..wz) (13 rows); returns the 13
    updated rows plus the stored world ang-vel rows (avx, avy, avz).
    Mirrors the kernel's formulas (`gpd_dyn_substeps`): the rotation rows
    are `q*q*inv_n2`, not a divide-by-norm.
    """
    (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz) = state_rows
    jx, jy, jz = params.ixx, params.iyy, params.izz
    inv_jx, inv_jy, inv_jz = 1.0 / jx, 1.0 / jy, 1.0 / jz
    inv_m = 1.0 / params.m
    gm = 9.8 * params.m

    avx = avy = avz = None
    for _ in range(n_substeps):
        n2 = qx * qx + qy * qy + qz * qz + qw * qw
        inv_n2 = 1.0 / n2
        xx, yy, zz = qx * qx * inv_n2, qy * qy * inv_n2, qz * qz * inv_n2
        xy, xz, yz = qx * qy * inv_n2, qx * qz * inv_n2, qy * qz * inv_n2
        wxq, wyq, wzq = qw * qx * inv_n2, qw * qy * inv_n2, qw * qz * inv_n2
        r00, r01, r02 = 1 - 2 * (yy + zz), 2 * (xy - wzq), 2 * (xz + wyq)
        r10, r11, r12 = 2 * (xy + wzq), 1 - 2 * (xx + zz), 2 * (yz - wxq)
        r20, r21, r22 = 2 * (xz - wyq), 2 * (yz + wxq), 1 - 2 * (xx + yy)

        fx = r02 * thrust
        fy = r12 * thrust
        fz = r22 * thrust - gm
        # tau -= w x (J w)
        tau_x = x_torque - (wy * (jz * wz) - wz * (jy * wy))
        tau_y = y_torque - (wz * (jx * wx) - wx * (jz * wz))
        tau_z = z_torque - (wx * (jy * wy) - wy * (jx * wx))

        vx = vx + dt * fx * inv_m
        vy = vy + dt * fy * inv_m
        vz = vz + dt * fz * inv_m
        wx = wx + dt * tau_x * inv_jx
        wy = wy + dt * tau_y * inv_jy
        wz = wz + dt * tau_z * inv_jz
        px = px + dt * vx
        py = py + dt * vy
        pz = pz + dt * vz

        # exact exponential-map quat update (body rates)
        norm = torch.sqrt(wx * wx + wy * wy + wz * wz)
        theta = norm * (dt / 2)
        c = torch.cos(theta)
        safe = torch.where(norm > 0, norm, 1.0)
        s = torch.sin(theta) / safe
        nqx = c * qx + s * (wz * qy - wy * qz + wx * qw)
        nqy = c * qy + s * (-wz * qx + wx * qz + wy * qw)
        nqz = c * qz + s * (wy * qx - wx * qy + wz * qw)
        nqw = c * qw + s * (-wx * qx - wy * qy - wz * qz)
        keep = norm <= 1e-8
        qx = torch.where(keep, qx, nqx)
        qy = torch.where(keep, qy, nqy)
        qz = torch.where(keep, qz, nqz)
        qw = torch.where(keep, qw, nqw)

        # stored world angular velocity: PRE-step rotation, post-step rates
        avx = r00 * wx + r01 * wy + r02 * wz
        avy = r10 * wx + r11 * wy + r12 * wz
        avz = r20 * wx + r21 * wy + r22 * wz

    return (px, py, pz, qx, qy, qz, qw, vx, vy, vz, wx, wy, wz,
            avx, avy, avz)


def dyn_ctrl_step_plain(params: DroneParams, state_rows: torch.Tensor,
                        rpm_rows: torch.Tensor, n_substeps: int, dt: float,
                        emit_obs12: bool = False):
    """Plain PyTorch version of the kernel: (16, B), (4, B) -> (16, B)
    [, obs12 (12, B)], on whatever device the inputs lie."""
    rows = tuple(state_rows[i] for i in range(13))
    thrust, x_t, y_t, z_t = motor_mix_rows(params, *rpm_rows)
    out = dyn_substeps_rows(params, n_substeps, dt, rows,
                            thrust, x_t, y_t, z_t)
    new = torch.stack(out)
    if not emit_obs12:
        return new
    roll, pitch, yaw = kernel_math.quat_rpy_rows(*out[3:7])
    obs12 = torch.stack(out[0:3] + (roll, pitch, yaw) + out[7:10]
                        + out[13:16])
    return new, obs12


def fill_drone_params(sp: _build.StepParams, params: DroneParams,
                      n_substeps: int, dt: float) -> None:
    """Write the drone constants, substep count and dt into a kernel
    parameter struct.  Every constant is computed in double precision and
    rounded once to float32, as a Python float is when it meets a float32
    tensor in the plain version."""
    km_s, k_arm, plus = _mix_consts(params)
    d = sp.drone
    d.kf, d.km_s, d.k_arm, d.plus_mixer = params.kf, km_s, k_arm, int(plus)
    d.inv_m, d.gm = 1.0 / params.m, 9.8 * params.m
    d.jx, d.jy, d.jz = params.ixx, params.iyy, params.izz
    d.inv_jx, d.inv_jy, d.inv_jz = (
        1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz)
    d.hover_rpm = params.hover_rpm
    sp.n_substeps, sp.dt, sp.half_dt = n_substeps, dt, dt / 2


@functools.lru_cache(maxsize=32)
def _step_params(params: DroneParams, n_substeps: int,
                 dt: float) -> _build.StepParams:
    sp = _build.StepParams()
    fill_drone_params(sp, params, n_substeps, dt)
    return sp


def check_rows(name: str, t: torch.Tensor, rows: int, like=None) -> None:
    """Raise unless `t` is a contiguous float32 (rows, B) block (on the
    device and with the width of `like`, when given)."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
        raise TypeError(f"{name} must be a float32 tensor")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, B), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if like is not None and (t.device != like.device
                             or t.shape[1] != like.shape[1]):
        raise ValueError(f"{name} must match the state block's device and "
                         f"width, got {t.device} {tuple(t.shape)}")


def dyn_ctrl_step_rows(params: DroneParams, state_rows: torch.Tensor,
                       rpm_rows: torch.Tensor, n_substeps: int, dt: float,
                       emit_obs12: bool = False):
    """The kernel's wrapper on packed rows: (16, B), (4, B) -> (16, B)
    [, obs12 (12, B)].

    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation; outputs from `torch.empty`); a CPU tensor runs
    `dyn_ctrl_step_plain`.  Anything the kernel does not take raises.
    The CPU path, or the launch, is the span `kernel.dyn_ctrl_step`
    (`utils.profiling.span`; attribute `columns`, B); the launch goes
    through `utils.graphs.launch`.
    """
    check_rows("state_rows", state_rows, S)
    check_rows("rpm_rows", rpm_rows, 4, like=state_rows)
    if n_substeps < 1:
        raise ValueError("n_substeps must be at least 1")
    b = state_rows.shape[1]
    if state_rows.device.type == "cpu":
        with span("kernel.dyn_ctrl_step", columns=b):
            return dyn_ctrl_step_plain(params, state_rows, rpm_rows,
                                       n_substeps, dt, emit_obs12)
    if state_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {state_rows.device}")
    fn = _build.load()["dyn_ctrl_step"]
    out = torch.empty_like(state_rows)
    obs12 = (torch.empty((12, b), dtype=torch.float32,
                         device=state_rows.device) if emit_obs12 else None)
    sp = _step_params(params, n_substeps, dt)

    def go():
        global launches
        with span("kernel.dyn_ctrl_step", columns=b), \
                torch.cuda.device(state_rows.device):
            err = fn(state_rows.data_ptr(), rpm_rows.data_ptr(),
                     out.data_ptr(), obs12.data_ptr() if emit_obs12 else None,
                     b, state_rows.stride(0), ctypes.byref(sp),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"dyn_ctrl_step launch failed: CUDA error "
                               f"{err}")
        launches += 1
    graphs.launch(go)
    return (out, obs12) if emit_obs12 else out


def _pack(state) -> torch.Tensor:
    """DynState-like pieces (B, k) -> (16, B) packed rows."""
    flat = torch.cat(
        [state.pos, state.quat, state.vel, state.rpy_rates, state.ang_v],
        dim=-1)                                       # (B, 16)
    return flat.t().contiguous()                      # (16, B)


def _unpack(packed: torch.Tensor, state):
    flat = packed.t()
    return state._replace(
        pos=flat[:, 0:3], quat=flat[:, 3:7], vel=flat[:, 7:10],
        rpy_rates=flat[:, 10:13], ang_v=flat[:, 13:16])


def dyn_ctrl_step(params: DroneParams, state, n_substeps: int, dt: float,
                  rpm: torch.Tensor, emit_obs12: bool = False):
    """Run n_substeps DYN substeps in one kernel launch.

    state: any NamedTuple with pos/quat/vel/rpy_rates/ang_v of shape (B, k)
    (flattened env*drone batch); rpm: (B, 4).  Returns the updated state
    (leaves are views of one (16, B) block), or (state, obs12 (B, 12)) when
    emit_obs12 — the RL tasks' kinematic observation block with the Euler
    extraction done in-kernel.
    """
    outs = dyn_ctrl_step_rows(params, _pack(state), rpm.t().contiguous(),
                              n_substeps, dt, emit_obs12)
    if not emit_obs12:
        return _unpack(outs, state)
    return _unpack(outs[0], state), outs[1].t()
