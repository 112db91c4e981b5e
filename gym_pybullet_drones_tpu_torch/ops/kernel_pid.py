"""CUDA kernel: one cascaded DSL-PID tick and one DYN control step (all
substeps) per launch.

Replaces the TPU kernel `gym_pybullet_drones_tpu/ops/pallas_pid.py:
pid_dyn_ctrl_step` (body `_pid_tick`, `_kernel`).  Source:
`csrc/pid_dyn_ctrl_step.cu`, device functions `gpd_pid_tick`,
`gpd_motor_mix`, `gpd_dyn_substeps` in `csrc/drone_kernels.cuh`.

The embedded-PID action paths (ActionType.PID / VEL / ONE_D_PID and the
routing task built on them) spend their step in the sixty-odd small tensor
operations of the cascaded PID (`control/dsl_pid.compute_control`), not in
the physics.  This kernel runs the whole control step — position loop,
target attitude, attitude loop, PWM mixer, motor mixing and all physics
substeps — with every intermediate in registers, on row blocks with one
column per (env x drone):

    state (16, B)   as in ops/kernel_dyn.py
    pid   (9, B)    last_rpy3, integral_pos_e3, integral_rpy_e3
    tgt   (12, B)   target pos3, rpy3, vel3, rpy_rates3
    -> state' (16, B), pid' (9, B), rpm (4, B) [, obs12 (12, B)]

What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; `PERF.md`): not
its bytes (13 + 9 + 12 rows read, 16 + 9 + 4 [+ 12] written, 1.5 us at
16384 columns) nor its operations (some 1,900 float32 a column), but the
launch floor (1.0-1.3 us) and one thread's dependent chain: one warp costs
within 10% of 16384 columns, and 65536 columns cost 1.6x as much.
The tick adds about 2 us to `dyn_ctrl_step`'s chain (divisions, square
roots, the inverse trig and four sine/cosine pairs before the substeps).
The design is K1's: one launch per control step, one thread per column,
everything in registers, coalesced row loads and stores, no lane padding,
the tail masked, every constant in the by-value parameter struct; the
tick's four sine/cosine pairs take `sincosf` (bit for bit the same
values), its arithmetic is otherwise the plain version's, expression by
expression.

The controller's parameters (`pid_params`) are passed apart from the
dynamics' (`dyn_params`): the env paths always pass CF2X (reference
BaseRLAviary.py:76), the controller's `kf` and `9.8 * m` are CF2X's even
when the drone is not.  Both PWM mixers (CF2X, CF2P) are kept.

Differences from the TPU kernel, all in the inverse trig: `atan2f` /
`asinf` replace its polynomials (see ops/kernel_math.py), and the asin
argument `z_ax[0]` is clipped to [-1, 1] here because `asinf` and
`torch.asin` return NaN for 1 + 1 ulp, which the normalisation can
produce, where the polynomial clipped its own argument.

`pid_tick_rows` / `pid_dyn_ctrl_step_plain` are the same row arithmetic in
plain PyTorch.  The wrapper uses them only for tensors that lie on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.params import DroneParams, G
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel
from gym_pybullet_drones_tpu_torch.control import dsl_pid as C
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_math
from gym_pybullet_drones_tpu_torch.ops.kernel_dyn import S, check_rows
from gym_pybullet_drones_tpu_torch.utils import graphs

PR = 9    # PID carry rows per column
TR = 12   # setpoint rows per column

launches = 0  # kernel launches made by `pid_dyn_ctrl_step_rows` (CUDA only)


def pid_tick_rows(pid_params: DroneParams, ctrl_dt: float, state_rows,
                  pid_rows, tgt_rows):
    """One cascaded-PID tick on (B,) row tensors.

    state_rows: 10+ rows (px..pz, qx..qw, vx..vz); pid_rows: 9 rows
    (last_rpy, integral_pos_e, integral_rpy_e); tgt_rows: 12 rows
    (target pos/rpy/vel/rpy_rates).  Returns (4 rpm rows, 9 new pid rows).
    Mirrors the kernel's formulas (`gpd_pid_tick`) line by line.
    """
    px, py, pz = state_rows[0:3]
    qx, qy, qz, qw = state_rows[3:7]
    vx, vy, vz = state_rows[7:10]
    lr = pid_rows[0:3]                    # last_rpy
    ip_x, ip_y, ip_z = pid_rows[3:6]      # integral pos error
    ir_x, ir_y, ir_z = pid_rows[6:9]      # integral rpy error
    tp = tgt_rows[0:3]                    # target_pos
    trpy = tgt_rows[3:6]                  # target_rpy
    tv = tgt_rows[6:9]                    # target_vel
    trr = tgt_rows[9:12]                  # target_rpy_rates
    clip = torch.clamp

    # current rotation matrix from the (normalization-invariant) quat
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    inv_n2 = 1.0 / n2
    xx, yy, zz = qx * qx * inv_n2, qy * qy * inv_n2, qz * qz * inv_n2
    xy, xz, yz = qx * qy * inv_n2, qx * qz * inv_n2, qy * qz * inv_n2
    wxq, wyq, wzq = qw * qx * inv_n2, qw * qy * inv_n2, qw * qz * inv_n2
    c00, c01, c02 = 1 - 2 * (yy + zz), 2 * (xy - wzq), 2 * (xz + wyq)
    c10, c11, c12 = 2 * (xy + wzq), 1 - 2 * (xx + zz), 2 * (yz - wxq)
    c20, c21, c22 = 2 * (xz - wyq), 2 * (yz + wxq), 1 - 2 * (xx + yy)

    # ---- position loop (control/dsl_pid.py, reference :149-208) ----
    pe = [tp[0] - px, tp[1] - py, tp[2] - pz]
    ve = [tv[0] - vx, tv[1] - vy, tv[2] - vz]
    ip_x = clip(ip_x + pe[0] * ctrl_dt, -2.0, 2.0)
    ip_y = clip(ip_y + pe[1] * ctrl_dt, -2.0, 2.0)
    ip_z = clip(clip(ip_z + pe[2] * ctrl_dt, -2.0, 2.0), -0.15, 0.15)
    ip = (ip_x, ip_y, ip_z)
    gravity = G * pid_params.m
    tt = [C.P_FOR[i] * pe[i] + C.I_FOR[i] * ip[i] + C.D_FOR[i] * ve[i]
          for i in range(3)]
    tt[2] = tt[2] + gravity
    scalar_thrust = clip(tt[0] * c02 + tt[1] * c12 + tt[2] * c22, min=0.0)
    thrust_pwm = (torch.sqrt(scalar_thrust / (4.0 * pid_params.kf))
                  - C.PWM2RPM_CONST) / C.PWM2RPM_SCALE
    tt_norm = torch.sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2])
    zax = [t / tt_norm for t in tt]
    cyaw, syaw = torch.cos(trpy[2]), torch.sin(trpy[2])
    # y_ax = normalize(z_ax x x_c), x_c = [cos yaw, sin yaw, 0]
    zxc = [-zax[2] * syaw, zax[2] * cyaw, zax[0] * syaw - zax[1] * cyaw]
    zxc_n = torch.sqrt(zxc[0] * zxc[0] + zxc[1] * zxc[1] + zxc[2] * zxc[2])
    yax = [v / zxc_n for v in zxc]
    xax0 = yax[1] * zax[2] - yax[2] * zax[1]
    # target rotation columns are (x_ax, y_ax, z_ax); intrinsic-XYZ Euler
    # (ops/quat.mat_to_euler_xyz): b = asin(m02), a = atan2(-m12, m22),
    # c = atan2(-m01, m00); the asin argument is clipped (module docstring)
    ea = torch.atan2(-zax[1], zax[2])
    eb = torch.asin(clip(zax[0], -1.0, 1.0))
    ec = torch.atan2(-yax[0], xax0)

    # ---- attitude loop (reference :212-259) ----
    cur = kernel_math.quat_rpy_rows(qx, qy, qz, qw)
    # R(target_euler) = Rx(ea) @ Ry(eb) @ Rz(ec)
    ca, sa = torch.cos(ea), torch.sin(ea)
    cb, sb = torch.cos(eb), torch.sin(eb)
    cc, sc = torch.cos(ec), torch.sin(ec)
    t00, t01, t02 = cb * cc, -cb * sc, sb
    t10, t11, t12 = ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb
    t20, t21, t22 = sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb
    # rot_matrix_e = Rt^T Rc - Rc^T Rt = E - E^T with E = Rt^T Rc
    e21 = t02 * c01 + t12 * c11 + t22 * c21
    e12 = t01 * c02 + t11 * c12 + t21 * c22
    e02 = t00 * c02 + t10 * c12 + t20 * c22
    e20 = t02 * c00 + t12 * c10 + t22 * c20
    e10 = t01 * c00 + t11 * c10 + t21 * c20
    e01 = t00 * c01 + t10 * c11 + t20 * c21
    rot_e = [e21 - e12, e02 - e20, e10 - e01]
    rre = [trr[i] - (cur[i] - lr[i]) / ctrl_dt for i in range(3)]
    ir_x = clip(clip(ir_x - rot_e[0] * ctrl_dt, -1500.0, 1500.0), -1.0, 1.0)
    ir_y = clip(clip(ir_y - rot_e[1] * ctrl_dt, -1500.0, 1500.0), -1.0, 1.0)
    ir_z = clip(ir_z - rot_e[2] * ctrl_dt, -1500.0, 1500.0)
    ir = (ir_x, ir_y, ir_z)
    tq = [clip(-C.P_TOR[i] * rot_e[i] + C.D_TOR[i] * rre[i]
               + C.I_TOR[i] * ir[i], -3200.0, 3200.0) for i in range(3)]
    rpm_rows = []
    for m in C.mixer_of(pid_params):
        pwm = thrust_pwm + m[0] * tq[0] + m[1] * tq[1] + m[2] * tq[2]
        pwm = clip(pwm, C.MIN_PWM, C.MAX_PWM)
        rpm_rows.append(C.PWM2RPM_SCALE * pwm + C.PWM2RPM_CONST)
    return rpm_rows, tuple(cur) + ip + ir


def pid_dyn_ctrl_step_plain(pid_params: DroneParams, dyn_params: DroneParams,
                            state_rows: torch.Tensor, pid_rows: torch.Tensor,
                            tgt_rows: torch.Tensor, n_substeps: int,
                            pyb_dt: float, ctrl_dt: float,
                            emit_obs12: bool = False):
    """Plain PyTorch version of the kernel: (16, B), (9, B), (12, B) ->
    (state' (16, B), pid' (9, B), rpm (4, B) [, obs12 (12, B)]), on
    whatever device the inputs lie."""
    rows = tuple(state_rows[i] for i in range(13))
    rpm_rows, new_pid = pid_tick_rows(pid_params, ctrl_dt, rows,
                                      tuple(pid_rows), tuple(tgt_rows))
    thrust, x_t, y_t, z_t = kernel_dyn.motor_mix_rows(dyn_params, *rpm_rows)
    out = kernel_dyn.dyn_substeps_rows(dyn_params, n_substeps, pyb_dt, rows,
                                       thrust, x_t, y_t, z_t)
    res = (torch.stack(out), torch.stack(new_pid), torch.stack(rpm_rows))
    if not emit_obs12:
        return res
    roll, pitch, yaw = kernel_math.quat_rpy_rows(*out[3:7])
    return res + (torch.stack(out[0:3] + (roll, pitch, yaw) + out[7:10]
                              + out[13:16]),)


def fill_pid_params(sp: _build.StepParams, pid_params: DroneParams,
                    ctrl_dt: float) -> None:
    """Write the controller's constants and the control step into a kernel
    parameter struct, each computed in double and rounded once."""
    sp.pid.kf4 = 4.0 * pid_params.kf
    sp.pid.gravity = G * pid_params.m
    sp.pid.plus_mixer = int(pid_params.model == DroneModel.CF2P)
    sp.ctrl_dt = ctrl_dt


@functools.lru_cache(maxsize=32)
def _step_params(pid_params: DroneParams, dyn_params: DroneParams,
                 n_substeps: int, pyb_dt: float,
                 ctrl_dt: float) -> _build.StepParams:
    sp = _build.StepParams()
    kernel_dyn.fill_drone_params(sp, dyn_params, n_substeps, pyb_dt)
    fill_pid_params(sp, pid_params, ctrl_dt)
    return sp


def pid_dyn_ctrl_step_rows(pid_params: DroneParams, dyn_params: DroneParams,
                           state_rows: torch.Tensor, pid_rows: torch.Tensor,
                           tgt_rows: torch.Tensor, n_substeps: int,
                           pyb_dt: float, ctrl_dt: float,
                           emit_obs12: bool = False):
    """The kernel's wrapper on packed rows: (16, B), (9, B), (12, B) ->
    (state' (16, B), pid' (9, B), rpm (4, B) [, obs12 (12, B)]).

    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation; outputs from `torch.empty`); a CPU tensor runs
    `pid_dyn_ctrl_step_plain`.  Anything the kernel does not take raises.
    The launch goes through `utils.graphs.launch`.
    """
    check_rows("state_rows", state_rows, S)
    check_rows("pid_rows", pid_rows, PR, like=state_rows)
    check_rows("tgt_rows", tgt_rows, TR, like=state_rows)
    if n_substeps < 1:
        raise ValueError("n_substeps must be at least 1")
    if pid_params.model not in (DroneModel.CF2X, DroneModel.CF2P):
        raise ValueError("the DSL-PID needs a CF2X or CF2P controller model")
    if state_rows.device.type == "cpu":
        return pid_dyn_ctrl_step_plain(
            pid_params, dyn_params, state_rows, pid_rows, tgt_rows,
            n_substeps, pyb_dt, ctrl_dt, emit_obs12)
    if state_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {state_rows.device}")
    fn = _build.load()["pid_dyn_ctrl_step"]
    b = state_rows.shape[1]
    new = lambda rows: torch.empty((rows, b), dtype=torch.float32,
                                   device=state_rows.device)
    out, pid_out, rpm_out = new(S), new(PR), new(4)
    obs12 = new(12) if emit_obs12 else None
    sp = _step_params(pid_params, dyn_params, n_substeps, pyb_dt, ctrl_dt)

    def go():
        global launches
        with torch.cuda.device(state_rows.device):
            err = fn(state_rows.data_ptr(), pid_rows.data_ptr(),
                     tgt_rows.data_ptr(), out.data_ptr(), pid_out.data_ptr(),
                     rpm_out.data_ptr(),
                     obs12.data_ptr() if emit_obs12 else None, b,
                     state_rows.stride(0), ctypes.byref(sp),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"pid_dyn_ctrl_step launch failed: CUDA error {err}")
        launches += 1
    graphs.launch(go)
    res = (out, pid_out, rpm_out)
    return res + (obs12,) if emit_obs12 else res


def pid_dyn_ctrl_step(pid_params: DroneParams, dyn_params: DroneParams,
                      state, pid_state: C.PIDState, n_substeps: int,
                      pyb_dt: float, ctrl_dt: float, target_pos, target_rpy,
                      target_vel, target_rpy_rates, emit_obs12: bool = False):
    """Fused DSL-PID tick + n DYN substeps in one kernel launch.

    state: NamedTuple with pos/quat/vel/rpy_rates/ang_v of shape (B, k)
    (flattened env*drone batch); pid_state: dsl_pid.PIDState with (B, 3)
    leaves; targets: (B, 3) each.  Returns (state', pid_state', rpm (B, 4))
    plus the in-kernel (B, 12) kinematic obs block when emit_obs12.  The
    returned leaves are views of the kernel's row blocks.
    """
    rows = lambda *leaves: torch.cat(leaves, dim=-1).t().contiguous()
    outs = pid_dyn_ctrl_step_rows(
        pid_params, dyn_params, kernel_dyn._pack(state),
        rows(pid_state.last_rpy, pid_state.integral_pos_e,
             pid_state.integral_rpy_e),
        rows(target_pos, target_rpy, target_vel, target_rpy_rates),
        n_substeps, pyb_dt, ctrl_dt, emit_obs12)
    pid_flat = outs[1].t()
    new_pid = C.PIDState(last_rpy=pid_flat[:, 0:3],
                         integral_pos_e=pid_flat[:, 3:6],
                         integral_rpy_e=pid_flat[:, 6:9])
    res = (kernel_dyn._unpack(outs[0], state), new_pid, outs[2].t())
    return res + (outs[3].t(),) if emit_obs12 else res
