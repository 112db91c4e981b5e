"""The plain reference's physics: one control step of the whole env on
(RC, B) carry rows, in plain PyTorch with no kernel.

A frozen copy of the row arithmetic that upstream gym-pybullet-drones'
env step reduces to, as the CUDA kernels of `gym_pybullet_drones_tpu_torch`
are held against it: the CF2X motor mix, the explicit-dynamics substeps
(DYN), the PyBullet-like rigid body with ground and drone-drone contact
(the PYB family), the embedded DSL-PID of PID-type actions, the action
history ring, the task's reward, flags and extra observations, and the
auto-reset select.  It imports nothing of the program: the program may
change its own plain versions, and this copy stays what the benchmark
judges against.  `ref_env.py` builds the spec, the drone and the tasks
that `fused_env_step_plain` reads from a configuration file.
"""
from __future__ import annotations

import math
from enum import Enum
from typing import NamedTuple

import torch

G = 9.8  # gravitational acceleration [m/s^2]


class DroneModel(Enum):
    CF2X = "cf2x"
    CF2P = "cf2p"
    RACE = "racer"


class Physics(Enum):
    PYB = "pyb"
    DYN = "dyn"
    PYB_GND = "pyb_gnd"
    PYB_DRAG = "pyb_drag"
    PYB_DW = "pyb_dw"
    PYB_GND_DRAG_DW = "pyb_gnd_drag_dw"


class ActionType(Enum):
    RPM = "rpm"
    PID = "pid"
    VEL = "vel"
    ONE_D_RPM = "one_d_rpm"
    ONE_D_PID = "one_d_pid"


DroneParams = object  # annotations only: see ref_env.Drone


# ---- from control.dsl_pid ----

P_FOR = (0.4, 0.4, 1.25)


I_FOR = (0.05, 0.05, 0.05)


D_FOR = (0.2, 0.2, 0.5)


P_TOR = (70000.0, 70000.0, 60000.0)


I_TOR = (0.0, 0.0, 500.0)


D_TOR = (20000.0, 20000.0, 12000.0)


PWM2RPM_SCALE = 0.2685


PWM2RPM_CONST = 4070.3


MIN_PWM = 20000.0


MAX_PWM = 65535.0


MIXER_CF2X = (
    (-0.5, -0.5, -1.0),
    (-0.5, 0.5, 1.0),
    (0.5, 0.5, -1.0),
    (0.5, -0.5, 1.0),
)


MIXER_CF2P = (
    (0.0, -1.0, -1.0),
    (1.0, 0.0, 1.0),
    (0.0, 1.0, -1.0),
    (-1.0, 0.0, 1.0),
)


def mixer_of(params: DroneParams):
    """The 4x3 PWM mixer of a controller's drone model."""
    return MIXER_CF2P if params.model == DroneModel.CF2P else MIXER_CF2X


# ---- from ops.rigid_body ----

LINEAR_DAMPING = 0.04


ANGULAR_DAMPING = 0.04


GROUND_FRICTION = 0.5     # lateral_friction default; no <contact> tag in URDFs


CONTACT_ERP = 0.2         # PyBullet contactERP default


SOLVER_ITERATIONS = 4     # PGS sweeps (island of <= 7 constraints: converged)


CONTACT_SLOP = 0.02       # speculative-contact window (Bullet's


def _prop_coef_pairs(coefs):
    """Greedy pairing of prop indices with opposite-equal coefficients.

    Returns ([(i, j, c)], leftovers): each pair contributes
    c * (f_i - f_j); leftovers contribute c_i * f_i.  All drone models'
    URDFs pair fully (X and + formations are symmetric)."""
    used = [False] * len(coefs)
    pairs, left = [], []
    for i in range(len(coefs)):
        if used[i]:
            continue
        for j in range(i + 1, len(coefs)):
            if not used[j] and coefs[j] == -coefs[i] and coefs[i] != 0.0:
                used[i] = used[j] = True
                pairs.append((i, j, coefs[i]))
                break
        else:
            if coefs[i] != 0.0:
                left.append(i)
            used[i] = True
    return pairs, left


# ---- from ops.kernel_math ----

def quat_rpy_rows(qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
                  qw: torch.Tensor):
    """Roll/pitch/yaw rows from (possibly un-normalized) quaternion rows."""
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    roll = torch.atan2(2.0 * (qw * qx + qy * qz),
                       n2 - 2.0 * (qx * qx + qy * qy))
    pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx) / n2, -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy),
                      n2 - 2.0 * (qy * qy + qz * qz))
    return roll, pitch, yaw


# ---- from ops.kernel_dyn ----

S = 16  # state rows per column


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


# ---- from ops.kernel_pid ----

PR = 9    # PID carry rows per column


TR = 12   # setpoint rows per column


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
    tt = [P_FOR[i] * pe[i] + I_FOR[i] * ip[i] + D_FOR[i] * ve[i]
          for i in range(3)]
    tt[2] = tt[2] + gravity
    scalar_thrust = clip(tt[0] * c02 + tt[1] * c12 + tt[2] * c22, min=0.0)
    thrust_pwm = (torch.sqrt(scalar_thrust / (4.0 * pid_params.kf))
                  - PWM2RPM_CONST) / PWM2RPM_SCALE
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
    cur = quat_rpy_rows(qx, qy, qz, qw)
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
    tq = [clip(-P_TOR[i] * rot_e[i] + D_TOR[i] * rre[i]
               + I_TOR[i] * ir[i], -3200.0, 3200.0) for i in range(3)]
    rpm_rows = []
    for m in mixer_of(pid_params):
        pwm = thrust_pwm + m[0] * tq[0] + m[1] * tq[1] + m[2] * tq[2]
        pwm = clip(pwm, MIN_PWM, MAX_PWM)
        rpm_rows.append(PWM2RPM_SCALE * pwm + PWM2RPM_CONST)
    return rpm_rows, tuple(cur) + ip + ir


# ---- from ops.kernel_env ----

GND_MODES = (Physics.PYB_GND, Physics.PYB_GND_DRAG_DW)


DRAG_MODES = (Physics.PYB_DRAG, Physics.PYB_GND_DRAG_DW)


DW_MODES = (Physics.PYB_DW, Physics.PYB_GND_DRAG_DW)


def _mv(r, v):
    """Rotation-rows 9-tuple @ 3-tuple."""
    return (r[0] * v[0] + r[1] * v[1] + r[2] * v[2],
            r[3] * v[0] + r[4] * v[1] + r[5] * v[2],
            r[6] * v[0] + r[7] * v[1] + r[8] * v[2])


def _mtv(r, v):
    """Transposed rotation-rows @ 3-tuple (world -> body)."""
    return (r[0] * v[0] + r[3] * v[1] + r[6] * v[2],
            r[1] * v[0] + r[4] * v[1] + r[7] * v[2],
            r[2] * v[0] + r[5] * v[1] + r[8] * v[2])


def _cr(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _iinv_w(r, j_inv, v):
    """World inverse inertia: R (J^-1 (R^T v)) on 3-tuples of rows."""
    b = _mtv(r, v)
    return _mv(r, (j_inv[0] * b[0], j_inv[1] * b[1], j_inv[2] * b[2]))


def _rot_rows(qx, qy, qz, qw):
    """Normalized rotation-matrix rows from quaternion rows (9-tuple)."""
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    inv = 1.0 / n2
    xx, yy, zz = qx * qx * inv, qy * qy * inv, qz * qz * inv
    xy, xz, yz = qx * qy * inv, qx * qz * inv, qy * qz * inv
    wx, wy, wz = qw * qx * inv, qw * qy * inv, qw * qz * inv
    return (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy))


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _tau_axis(params: DroneParams, rpm4, coefs):
    """sum_i coefs[i] * kf * rpm_i^2 as paired factored differences
    (`rigid_body._prop_coef_pairs`): exact cancellation for equal rpms."""
    pairs, left = _prop_coef_pairs(coefs)
    out = 0.0
    for i, j, c in pairs:
        ri, rj = rpm4[i], rpm4[j]
        out = out + ((ri - rj) * (ri + rj)) * (c * params.kf)
    for i in left:
        out = out + (rpm4[i] * rpm4[i]) * (coefs[i] * params.kf)
    return out


def obstacle_rows(entry, p, rc: float):
    """((nx, ny, nz), depth) rows of one static obstacle against a body of
    bounding radius `rc` centred at the position rows `p`; mirrors
    `gpd_obstacle_contact`.  4-tuple = sphere, 6-tuple = axis-aligned box
    (inside: the face of least penetration, the first minimum)."""
    if len(entry) == 4:
        ox, oy, oz, orad = entry
        dx, dy, dz = p[0] - ox, p[1] - oy, p[2] - oz
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        inv_d = 1.0 / torch.clamp(dist, min=1e-6)
        return (dx * inv_d, dy * inv_d, dz * inv_d), (orad + rc) - dist
    ox, oy, oz, hx, hy, hz = entry
    rx, ry, rz = p[0] - ox, p[1] - oy, p[2] - oz
    cx, cy, cz = _clip(rx, -hx, hx), _clip(ry, -hy, hy), _clip(rz, -hz, hz)
    dx, dy, dz = rx - cx, ry - cy, rz - cz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    outside = dist > 1e-6
    inv_d = 1.0 / torch.clamp(dist, min=1e-6)
    px_ = (hx + rc) - torch.abs(rx)
    py_ = (hy + rc) - torch.abs(ry)
    pz_ = (hz + rc) - torch.abs(rz)
    isx = (px_ <= py_) & (px_ <= pz_)
    isy = ~isx & (py_ <= pz_)
    isz = ~isx & ~isy
    sgx = torch.where(rx >= 0, 1.0, -1.0)
    sgy = torch.where(ry >= 0, 1.0, -1.0)
    sgz = torch.where(rz >= 0, 1.0, -1.0)
    zero = dist * 0.0
    nx = torch.where(outside, dx * inv_d, torch.where(isx, sgx, zero))
    ny = torch.where(outside, dy * inv_d, torch.where(isy, sgy, zero))
    nz = torch.where(outside, dz * inv_d, torch.where(isz, sgz, zero))
    pen_in = torch.minimum(torch.minimum(px_, py_), pz_)
    depth = torch.where(outside, rc - dist, pen_in)
    return (nx, ny, nz), depth


def pyb_substep_rows(params: DroneParams, physics: Physics, dt: float,
                     obstacles, drones, rpm, drag_rpm,
                     sweeps: int = SOLVER_ITERATIONS) -> None:
    """One coupled PYB substep for every drone of the env, on (B,) rows.

    drones: list of dicts with row lists p[3], q[4], v[3], w[3] (world
    angular velocity); rpm / drag_rpm: per-drone lists of 4 rows.  Mutates
    `drones`.  Mirrors the device functions under `gpd_pyb_ctrl_substeps`
    line by line; change them together.
    """
    n = len(drones)
    kf, km = params.kf, params.km
    offs = params.prop_offsets                        # ((ox, oy, oz) x4)
    lin_damp = (1.0 - LINEAR_DAMPING) ** dt
    ang_damp = (1.0 - ANGULAR_DAMPING) ** dt

    # ---- pre-substep rotations (shared by force terms) ----
    rots = [_rot_rows(*d["q"]) for d in drones]

    # ---- forces/torques per drone from the PRE-substep state ----
    forces, torques = [], []
    for di, d in enumerate(drones):
        r = rots[di]
        f = [rr * rr * kf for rr in rpm[di]]          # per-motor thrusts
        thrust = f[0] + f[1] + f[2] + f[3]
        r0, r1, r2, r3 = rpm[di]
        km_s = -km if params.model == DroneModel.RACE else km
        z_torque = (((r1 - r0) * (r1 + r0)) + ((r3 - r2) * (r3 + r2))) * km_s
        # tau_body = sum_i offset_i x [0, 0, f_i]  (+ z_torque about z)
        tau_bx = _tau_axis(params, rpm[di], [offs[i][1] for i in range(4)])
        tau_by = _tau_axis(params, rpm[di], [-offs[i][0] for i in range(4)])
        tau_bz = z_torque
        fx = r[2] * thrust
        fy = r[5] * thrust
        fz = r[8] * thrust
        tx = r[0] * tau_bx + r[1] * tau_by + r[2] * tau_bz
        ty = r[3] * tau_bx + r[4] * tau_by + r[5] * tau_bz
        tz = r[6] * tau_bx + r[7] * tau_by + r[8] * tau_bz

        if physics in GND_MODES:
            # ground effect: per-prop heights via analytic FK, gated on
            # |roll|, |pitch| < pi/2
            roll, pitch, _ = quat_rpy_rows(*d["q"])
            upright = ((torch.abs(roll) < math.pi / 2)
                       & (torch.abs(pitch) < math.pi / 2))
            gate = upright.to(roll.dtype)
            for i in range(4):
                ox, oy = offs[i][0], offs[i][1]
                wox = r[0] * ox + r[1] * oy
                woy = r[3] * ox + r[4] * oy
                woz = r[6] * ox + r[7] * oy
                h = torch.clamp(d["p"][2] + woz, min=params.gnd_eff_h_clip)
                g = (f[i] * params.gnd_eff_coeff
                     * (params.prop_radius / (4.0 * h)) ** 2) * gate
                gx, gy, gz = g * r[2], g * r[5], g * r[8]
                fx, fy, fz = fx + gx, fy + gy, fz + gz
                # torque: world_off x world-frame prop force
                tx = tx + (woy * gz - woz * gy)
                ty = ty + (woz * gx - wox * gz)
                tz = tz + (wox * gy - woy * gx)

        if physics in DRAG_MODES:
            # drag with the stale-action rpm of this substep
            dr = drag_rpm[di]
            omega = (dr[0] + dr[1] + dr[2] + dr[3]) * (2.0 * math.pi / 60.0)
            pre = [-params.drag_coeff[k] * omega * d["v"][k]
                   for k in range(3)]
            bx = r[0] * pre[0] + r[3] * pre[1] + r[6] * pre[2]   # R^T pre
            by = r[1] * pre[0] + r[4] * pre[1] + r[7] * pre[2]
            bz = r[2] * pre[0] + r[5] * pre[1] + r[8] * pre[2]
            fx = fx + r[0] * bx + r[1] * by + r[2] * bz          # R body
            fy = fy + r[3] * bx + r[4] * by + r[5] * bz
            fz = fz + r[6] * bx + r[7] * by + r[8] * bz

        if physics in DW_MODES:
            # downwash: every drone above receiver di
            total = None
            for si in range(n):
                if si == di:
                    continue
                src = drones[si]
                dz = src["p"][2] - d["p"][2]
                dx = src["p"][0] - d["p"][0]
                dy = src["p"][1] - d["p"][1]
                dxy = torch.sqrt(dx * dx + dy * dy)
                mask = (dz > 0) & (dxy < 10.0)
                safe_dz = torch.where(mask, dz, 1.0)
                alpha = params.dw_coeff_1 * \
                    (params.prop_radius / (4.0 * safe_dz)) ** 2
                beta = params.dw_coeff_2 * safe_dz + params.dw_coeff_3
                mag = alpha * torch.exp(-0.5 * (dxy / beta) ** 2)
                mag = torch.where(mask, mag, 0.0)
                total = mag if total is None else total + mag
            if total is not None:
                fx = fx - total * r[2]
                fy = fy - total * r[5]
                fz = fz - total * r[8]

        forces.append((fx, fy, fz))
        torques.append((tx, ty, tz))

    # ---- integrate every drone ----
    inv_m = 1.0 / params.m
    j_diag = (params.ixx, params.iyy, params.izz)
    j_inv = (1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz)
    mu = GROUND_FRICTION
    beta = CONTACT_ERP / dt
    inv_dt = 1.0 / dt
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    for di, d in enumerate(drones):
        r = rots[di]
        fx, fy, fz = forces[di]
        tx, ty, tz = torques[di]
        v = d["v"]
        v[0] = (v[0] + dt * fx * inv_m) * lin_damp
        v[1] = (v[1] + dt * fy * inv_m) * lin_damp
        v[2] = (v[2] + dt * (fz * inv_m - 9.8)) * lin_damp
        # dw_b = J^-1 (R^T tau - w_b x (J w_b))
        w = d["w"]
        tb = _mtv(r, (tx, ty, tz))
        wb = _mtv(r, (w[0], w[1], w[2]))
        gy = _cr(wb, (j_diag[0] * wb[0], j_diag[1] * wb[1],
                      j_diag[2] * wb[2]))
        db = (j_inv[0] * (tb[0] - gy[0]), j_inv[1] * (tb[1] - gy[1]),
              j_inv[2] * (tb[2] - gy[2]))
        dw = _mv(r, db)
        w[0] = (w[0] + dt * dw[0]) * ang_damp
        w[1] = (w[1] + dt * dw[1]) * ang_damp
        w[2] = (w[2] + dt * dw[2]) * ang_damp

        # ---- contact solve on the PRE-substep pose (PGS) ----
        p = d["p"]
        arms, pens = [], []
        for cx, cy in ((rc, 0.0), (0.0, rc), (-rc, 0.0), (0.0, -rc)):
            arm = _mv(r, (cx, cy, zoff - h2))
            arms.append(arm)
            pens.append(-(p[2] + arm[2]))
        zero = torch.zeros_like(p[2])
        nvec = (zero, zero, zero + 1.0)
        t1v = (zero + 1.0, zero, zero)
        t2v = (zero, zero + 1.0, zero)
        kn, kt1, kt2 = [], [], []
        for arm in arms:
            rxn = _cr(arm, nvec)
            kn.append(inv_m + _dot3(_cr(_iinv_w(r, j_inv, rxn), arm), nvec))
            rxt = _cr(arm, t1v)
            kt1.append(inv_m + _dot3(_cr(_iinv_w(r, j_inv, rxt), arm), t1v))
            rxt = _cr(arm, t2v)
            kt2.append(inv_m + _dot3(_cr(_iinv_w(r, j_inv, rxt), arm), t2v))
        acc_n = [zero] * 4
        acc_t1 = [zero] * 4
        acc_t2 = [zero] * 4
        # static obstacles as centred contacts: (normal rows, depth row)
        extras = [obstacle_rows(entry, p, rc) for entry in obstacles]
        extra_acc = [zero] * len(extras)
        extra_t = [zero] * len(extras)
        for _ in range(sweeps):
            for ki in range(4):
                arm = arms[ki]
                a = (pens[ki] > -CONTACT_SLOP).to(zero.dtype)
                # normal impulse (accumulated, clamped >= 0); speculative
                # target: Baumgarte push-out when penetrating, closing
                # limit depth/dt when separated within the slop window
                wxr = _cr((w[0], w[1], w[2]), arm)
                vn = v[2] + wxr[2]
                tgt = torch.where(pens[ki] > 0, beta * pens[ki],
                                  inv_dt * pens[ki])
                dj = (tgt - vn) / kn[ki]
                new_acc = torch.clamp(acc_n[ki] + dj, min=0.0) * a
                dj = new_acc - acc_n[ki]
                acc_n[ki] = new_acc
                v[2] = v[2] + inv_m * dj
                dwv = _iinv_w(r, j_inv, _cr(arm, (zero, zero, dj)))
                w[0], w[1], w[2] = w[0] + dwv[0], w[1] + dwv[1], w[2] + dwv[2]
                lim = mu * acc_n[ki]
                # tangential impulses (Coulomb cone on accumulated normal)
                for tdir, kt, acc_t in ((0, kt1, acc_t1), (1, kt2, acc_t2)):
                    wxr = _cr((w[0], w[1], w[2]), arm)
                    vt = v[tdir] + wxr[tdir]
                    dj = -vt / kt[ki]
                    new_acc = torch.minimum(
                        torch.maximum(acc_t[ki] + dj, -lim), lim) * a
                    dj = new_acc - acc_t[ki]
                    acc_t[ki] = new_acc
                    v[tdir] = v[tdir] + inv_m * dj
                    imp = (dj, zero, zero) if tdir == 0 else (zero, dj, zero)
                    dwv = _iinv_w(r, j_inv, _cr(arm, imp))
                    w[0], w[1], w[2] = (w[0] + dwv[0], w[1] + dwv[1],
                                        w[2] + dwv[2])
            for ei, (en, depth) in enumerate(extras):
                a = (depth > -CONTACT_SLOP).to(zero.dtype)
                vn = v[0] * en[0] + v[1] * en[1] + v[2] * en[2]
                tgt = torch.where(depth > 0, beta * depth, inv_dt * depth)
                dj = (tgt - vn) * params.m
                new_acc = torch.clamp(extra_acc[ei] + dj, min=0.0) * a
                dj = new_acc - extra_acc[ei]
                extra_acc[ei] = new_acc
                v[0] = v[0] + dj * inv_m * en[0]
                v[1] = v[1] + dj * inv_m * en[1]
                v[2] = v[2] + dj * inv_m * en[2]
                # linear Coulomb friction; ACCUMULATED tangential impulse
                # clamped to the cone mu*acc_n
                vn2 = v[0] * en[0] + v[1] * en[1] + v[2] * en[2]
                vtx = v[0] - vn2 * en[0]
                vty = v[1] - vn2 * en[1]
                vtz = v[2] - vn2 * en[2]
                vt_norm = torch.sqrt(vtx * vtx + vty * vty + vtz * vtz)
                j_stop = vt_norm * params.m
                new_t = torch.minimum(extra_t[ei] + j_stop, mu * new_acc) * a
                dj_t = torch.clamp(new_t - extra_t[ei], min=0.0)
                extra_t[ei] = new_t
                lim_v = dj_t * inv_m
                scale = torch.where(
                    vt_norm > 1e-9,
                    torch.clamp(vt_norm - lim_v, min=0.0)
                    / torch.clamp(vt_norm, min=1e-9), 1.0)
                scale = torch.where(a > 0, scale, 1.0)
                v[0] = vtx * scale + (v[0] - vtx)
                v[1] = vty * scale + (v[1] - vty)
                v[2] = vtz * scale + (v[2] - vtz)

        # ---- position integration with the corrected velocities ----
        p[0] = p[0] + dt * v[0]
        p[1] = p[1] + dt * v[1]
        p[2] = p[2] + dt * v[2]
        # world-frame exponential-map quat update (left Hamilton product)
        norm = torch.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        theta = norm * (dt / 2)
        c = torch.cos(theta)
        safe = torch.where(norm > 0, norm, 1.0)
        s = torch.sin(theta) / safe
        ax, ay, az = s * w[0], s * w[1], s * w[2]   # sin(theta) * axis
        qx, qy, qz, qw = d["q"]
        nqx = c * qx + ax * qw + ay * qz - az * qy
        nqy = c * qy - ax * qz + ay * qw + az * qx
        nqz = c * qz + ax * qy - ay * qx + az * qw
        nqw = c * qw - ax * qx - ay * qy - az * qz
        keep = norm <= 1e-8
        d["q"][0] = torch.where(keep, qx, nqx)
        d["q"][1] = torch.where(keep, qy, nqy)
        d["q"][2] = torch.where(keep, qz, nqz)
        d["q"][3] = torch.where(keep, qw, nqw)

    # ---- pairwise drone-drone contact: cylinder-manifold contact with full
    # angular response on the post-step poses, from a snapshot of p, v, w;
    # each unordered pair once, -imp to the partner ----
    if n > 1:
        min_d = 2.0 * params.collision_r
        post_rots = [_rot_rows(*d["q"]) for d in drones]
        snap = [(list(d["p"]), list(d["v"]), list(d["w"])) for d in drones]

        def _cyl_clamp(p_, r_, mx, my, mz):
            # world point clamped into this body's collision cylinder
            u = _mtv(r_, (mx - p_[0], my - p_[1], mz - p_[2]))
            ur = torch.sqrt(u[0] * u[0] + u[1] * u[1])
            s = torch.clamp(rc / torch.clamp(ur, min=1e-9), max=1.0)
            wq = _mv(r_, (u[0] * s, u[1] * s,
                          _clip(u[2], zoff - h2, zoff + h2)))
            return (p_[0] + wq[0], p_[1] + wq[1], p_[2] + wq[2])

        acc_v = [[None, None, None] for _ in range(n)]
        acc_w = [[None, None, None] for _ in range(n)]

        def _acc(slot, vals):
            for k in range(3):
                slot[k] = vals[k] if slot[k] is None else slot[k] + vals[k]

        for i in range(n):
            pi, vi, wi = snap[i]
            ri_ = post_rots[i]
            for j in range(i + 1, n):
                pj, vj, wj = snap[j]
                rj_ = post_rots[j]
                dx, dy, dz = pi[0] - pj[0], pi[1] - pj[1], pi[2] - pj[2]
                dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
                depth = min_d - dist
                hitm = ((depth > -CONTACT_SLOP)
                        & (dist > 1e-6)).to(dist.dtype)
                inv_d = 1.0 / torch.clamp(dist, min=1e-6)
                nv = (dx * inv_d, dy * inv_d, dz * inv_d)
                mx = 0.5 * (pi[0] + pj[0])
                my = 0.5 * (pi[1] + pj[1])
                mz = 0.5 * (pi[2] + pj[2])
                si = _cyl_clamp(pi, ri_, mx, my, mz)
                sj = _cyl_clamp(pj, rj_, mx, my, mz)
                r_i = (0.5 * (si[0] + sj[0]) - pi[0],
                       0.5 * (si[1] + sj[1]) - pi[1],
                       0.5 * (si[2] + sj[2]) - pi[2])
                r_j = (0.5 * (si[0] + sj[0]) - pj[0],
                       0.5 * (si[1] + sj[1]) - pj[1],
                       0.5 * (si[2] + sj[2]) - pj[2])
                wxr_i = _cr((wi[0], wi[1], wi[2]), r_i)
                wxr_j = _cr((wj[0], wj[1], wj[2]), r_j)
                rel = (vi[0] + wxr_i[0] - vj[0] - wxr_j[0],
                       vi[1] + wxr_i[1] - vj[1] - wxr_j[1],
                       vi[2] + wxr_i[2] - vj[2] - wxr_j[2])
                vn = _dot3(rel, nv)
                tgt = torch.where(depth > 0, beta * depth, inv_dt * depth)

                def keff(dvec):
                    t_i = _dot3(_cr(_iinv_w(ri_, j_inv, _cr(r_i, dvec)),
                                    r_i), dvec)
                    t_j = _dot3(_cr(_iinv_w(rj_, j_inv, _cr(r_j, dvec)),
                                    r_j), dvec)
                    return 2.0 * inv_m + t_i + t_j

                j_n = torch.clamp(tgt - vn, min=0.0) / keff(nv) * hitm
                vtv = (rel[0] - vn * nv[0], rel[1] - vn * nv[1],
                       rel[2] - vn * nv[2])
                vt_n = torch.sqrt(_dot3(vtv, vtv))
                inv_vt = 1.0 / torch.clamp(vt_n, min=1e-9)
                tv = (vtv[0] * inv_vt, vtv[1] * inv_vt, vtv[2] * inv_vt)
                j_t = torch.minimum(vt_n / keff(tv), mu * j_n) * hitm
                imp = (j_n * nv[0] - j_t * tv[0],
                       j_n * nv[1] - j_t * tv[1],
                       j_n * nv[2] - j_t * tv[2])
                imp_n = (-imp[0], -imp[1], -imp[2])
                _acc(acc_v[i], imp)
                _acc(acc_w[i], _iinv_w(ri_, j_inv, _cr(r_i, imp)))
                _acc(acc_v[j], imp_n)
                _acc(acc_w[j], _iinv_w(rj_, j_inv, _cr(r_j, imp_n)))
        for i in range(n):
            vi_live = drones[i]["v"]
            vi_live[0] = vi_live[0] + inv_m * acc_v[i][0]
            vi_live[1] = vi_live[1] + inv_m * acc_v[i][1]
            vi_live[2] = vi_live[2] + inv_m * acc_v[i][2]
            wi_live = drones[i]["w"]
            wi_live[0] = wi_live[0] + acc_w[i][0]
            wi_live[1] = wi_live[1] + acc_w[i][1]
            wi_live[2] = wi_live[2] + acc_w[i][2]


def pyb_ctrl_step_rows(params: DroneParams, physics: Physics, n_substeps: int,
                       dt: float, obstacles, states, rpms, last_rpms,
                       sweeps: int = SOLVER_ITERATIONS):
    """All substeps of one control step for the drones of an env.

    states: per drone 16 state rows; rpms / last_rpms: per drone 4 rows.
    Returns per drone the 16 stepped rows: `rpy_rates` (rows 10-12) pass
    through, the world `ang_v` rows 13-15 are carried state.  Substep 0's
    drag uses `last_rpms`, later substeps the new rpm.  Shared by
    `env_ctrl_step_plain` and `kernel_fused.fused_env_step_plain`.
    """
    drones = [{"p": list(s[0:3]), "q": list(s[3:7]), "v": list(s[7:10]),
               "w": list(s[13:16])} for s in states]
    drag = physics in DRAG_MODES
    for step_i in range(n_substeps):
        drag_rpm = last_rpms if (drag and step_i == 0) else rpms
        pyb_substep_rows(params, physics, dt, obstacles, drones, rpms,
                         drag_rpm, sweeps)
    return [tuple(dr["p"] + dr["q"] + dr["v"] + list(s[10:13]) + dr["w"])
            for dr, s in zip(drones, states)]


# ---- from ops.kernel_fused ----

S = 16    # state rows per drone

_ACT_IDS = {ActionType.RPM: 0, ActionType.ONE_D_RPM: 1, ActionType.PID: 2,
            ActionType.VEL: 3, ActionType.ONE_D_PID: 4}

LR = 4    # last-rpm rows per drone


PID_FAMILY = (ActionType.PID, ActionType.VEL, ActionType.ONE_D_PID)


def _layout(n: int, buf_rows: int, act: ActionType = ActionType.RPM):
    """(rows per drone, carry rows RC) for `n` drones."""
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported action type {act}")
    per_drone = S + LR + (PR if act in PID_FAMILY else 0) + buf_rows
    return per_drone, n * per_drone + 1          # + step-counter row


class PidSetpointConsts(NamedTuple):
    """How a PID-type action becomes a position setpoint; shared by
    `RLTask._pid_targets`, `pid_setpoint_rows` and the kernel's parameter
    struct."""

    step_size: float        # waypoint clamp (reference BaseRLAviary: 1.0)
    relative: bool          # action is a displacement, not a destination
    action_scale: float     # displacement per unit action when relative


def pid_setpoint_consts(task) -> PidSetpointConsts:
    """RoutingTask overrides these through its fields; the reference's RL
    aviaries use an absolute destination and a unit step."""
    step = float(getattr(task, "step_size", 1.0))
    return PidSetpointConsts(
        step, bool(getattr(task, "relative_actions", False)),
        float(getattr(task, "action_scale", step)))


def pid_setpoint_rows(cfg, task, st, a):
    """The embedded PID's 12 setpoint rows (target pos, rpy, vel, rpy
    rates) from one drone's PRE-step state rows and RAW action rows, per
    `RLTask._pid_targets`; mirrors `gpd_pid_setpoints`."""
    p, q = st[0:3], st[3:7]
    zero = p[0] * 0.0
    if task.act == ActionType.PID:
        # waypoint clamp (core.next_waypoint; reference
        # BaseAviary._calculateNextStep :1105-1147)
        c = pid_setpoint_consts(task)
        dest = [p[k] + c.action_scale * a[k] for k in range(3)] \
            if c.relative else list(a[0:3])
        dx = [dest[k] - p[k] for k in range(3)]
        dist = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
        safe = torch.where(dist > 0.0, dist, 1.0)
        tp = [torch.where(dist <= c.step_size, dest[k],
                          p[k] + dx[k] / safe * c.step_size)
              for k in range(3)]
        return tp + [zero] * 9
    if task.act == ActionType.VEL:
        vx, vy, vz, sf = a
        norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
        inv = torch.where(norm > 0.0,
                          1.0 / torch.where(norm > 0.0, norm, 1.0), 0.0)
        mag = cfg.drone.speed_limit * torch.abs(sf) * inv
        _, _, yaw = quat_rpy_rows(*q)
        return (list(p) + [zero, zero, yaw]
                + [mag * vx, mag * vy, mag * vz] + [zero] * 3)
    # ONE_D_PID: a height offset
    return [p[0], p[1], p[2] + 0.1 * a[0]] + [zero] * 9


def fused_env_step_plain(spec: FusedSpec, carry: torch.Tensor,
                         action_rows: torch.Tensor):
    """Plain PyTorch version of the kernel: carry (RC, B), action rows
    (N*A, B) -> (carry' (RC, B), outs (RO, B))."""
    cfg, task, n = spec.cfg, spec.task, spec.n
    params, act, act_dim, buf_rows = cfg.drone, task.act, spec.act_dim, \
        spec.buf_rows
    per_drone, _ = _layout(n, buf_rows, act)
    hover = params.hover_rpm
    has_pid = act in PID_FAMILY
    pid_off = S + LR
    buf_off = pid_off + (PR if has_pid else 0)

    # ---- action mapping + buffer shift + physics ----
    pyb = cfg.physics != Physics.DYN
    stepped, new_bufs, new_pids, rpms, lasts = [], [], [], [], []
    for d in range(n):
        base = d * per_drone
        st = [carry[base + k] for k in range(S if pyb else 13)]
        a = action_rows[d * act_dim:(d + 1) * act_dim]
        if act == ActionType.RPM:
            rpm = [hover * (1.0 + 0.05 * a[k]) for k in range(4)]
        elif act == ActionType.ONE_D_RPM:  # one action over the four motors
            rpm = [hover * (1.0 + 0.05 * a[0])] * 4
        else:
            # embedded DSL-PID tick, always the CF2X controller; the ring
            # below stores the RAW action
            rpm, new_pid = pid_tick_rows(
                spec.pid_drone, cfg.ctrl_dt, st,
                tuple(carry[base + pid_off:base + pid_off + PR]),
                pid_setpoint_rows(cfg, task, st, a))
            new_pids.append(new_pid)
        rpms.append(rpm)
        # history ring: oldest first (reference BaseRLAviary.py:66-67)
        buf = carry[base + buf_off:base + buf_off + buf_rows]
        new_bufs.append(torch.cat([buf[act_dim:], a]) if buf_rows else buf)
        if pyb:
            # PYB family: coupled, stepped below once every drone has rpm
            stepped.append(st)
            lasts.append(list(carry[base + S:base + S + LR]))
            continue
        thrust, xt, yt, zt = motor_mix_rows(params, *rpm)
        stepped.append(dyn_substeps_rows(
            params, cfg.steps_per_ctrl, cfg.pyb_dt, tuple(st),
            thrust, xt, yt, zt))
    if pyb:
        stepped = pyb_ctrl_step_rows(
            params, cfg.physics, cfg.steps_per_ctrl, cfg.pyb_dt,
            cfg.obstacles, stepped, rpms, lasts, cfg.solver_iterations)

    # ---- task post on the stepped rows ----
    sc_row = carry[n * per_drone]
    sc_new = sc_row + float(cfg.steps_per_ctrl)
    dinfo = []
    for o in stepped:
        dinfo.append({"p": o[0:3], "rpy": quat_rpy_rows(*o[3:7]),
                      "v": o[7:10], "w": o[13:16]})
    # row_post sees the PRE-increment substep counter: the reference advances
    # step_counter only after the termination hooks (BaseAviary.py:376-382)
    reward, term, trunc = task.row_post(cfg, dinfo, sc_row)
    done = term | trunc

    # ---- auto-reset select: every carry row of a done env ----
    carry_out = torch.empty_like(carry)
    outs = torch.empty((spec.out_rows, carry.shape[1]), dtype=carry.dtype,
                       device=carry.device)
    obs_rows_per = spec.obs_rows_per
    sel_dinfo = []
    for d in range(n):
        base, ob = d * per_drone, d * obs_rows_per
        for k in range(S):
            carry_out[base + k] = torch.where(done, spec.init16[d][k],
                                              stepped[d][k])
        for k in range(LR):
            carry_out[base + S + k] = torch.where(done, 0.0, rpms[d][k])
        if has_pid:
            for k in range(PR):
                carry_out[base + pid_off + k] = torch.where(
                    done, 0.0, new_pids[d][k])
        if buf_rows:
            carry_out[base + buf_off:base + buf_off + buf_rows] = \
                torch.where(done, 0.0, new_bufs[d])
        # ---- observation rows from the SELECTED (post-reset) state ----
        sel = carry_out[base:base + S]
        roll, pitch, yaw = quat_rpy_rows(*sel[3:7])
        outs[ob:ob + 3] = sel[0:3]
        outs[ob + 3], outs[ob + 4], outs[ob + 5] = roll, pitch, yaw
        outs[ob + 6:ob + 9] = sel[7:10]
        outs[ob + 9:ob + 12] = sel[13:16]
        outs[ob + 12:ob + 12 + buf_rows] = \
            carry_out[base + buf_off:base + buf_off + buf_rows]
        sel_dinfo.append({"p": list(sel[0:3]), "rpy": (roll, pitch, yaw),
                          "v": list(sel[7:10]), "w": list(sel[13:16])})
    if spec.n_extra:
        # task extras (routing: goal vector, nearest neighbour) see the
        # selected positions of ALL drones
        for d, rows in enumerate(task.row_extra_obs(cfg, sel_dinfo)):
            ob = d * obs_rows_per + 12 + buf_rows
            for k, row in enumerate(rows):
                outs[ob + k] = row
    carry_out[n * per_drone] = torch.where(done, 0.0, sc_new)
    ro = n * obs_rows_per
    outs[ro] = reward
    outs[ro + 1] = term.to(carry.dtype)
    outs[ro + 2] = trunc.to(carry.dtype)
    return carry_out, outs

