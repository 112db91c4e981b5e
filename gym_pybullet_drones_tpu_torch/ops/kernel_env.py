"""CUDA kernel: one control step of every drone of an env, ALL physics
modes — optional cascaded DSL-PID tick per drone, then `n_substeps` coupled
PYB-family substeps over the drones of the env (or the explicit DYN
substeps per drone), optional obs12 — in one launch.

Replaces the TPU kernel `gym_pybullet_drones_tpu/ops/pallas_env.py:
env_ctrl_step` (bodies `_kernel`, `_pyb_substep_all`).  Source:
`csrc/env_ctrl_step.cu`; the coupled substeps are the device function
`gpd_pyb_ctrl_substeps` in `csrc/drone_kernels.cuh`, which
`csrc/fused_env_step.cu` calls as well.

The PYB-family modes couple the drones of an env — downwash needs every
drone's PRE-substep position, drone-drone contact every drone's post-step
pose.  One thread owns one (env, drone); a block holds 32 envs of N drones,
warp w being drone w, and the drones of an env exchange their poses through
shared memory with a barrier per substep.  Per substep and drone: forces and torques from the pre-substep state (per-motor thrust,
paired factored torque differences, ground effect, drag with the stale rpm,
downwash), semi-implicit velocity update with the gyroscopic bias and
damping, a projected Gauss-Seidel contact solve on the pre-substep pose (4
rim points against the ground plus one centred contact per sphere or box
obstacle), position and world-frame quaternion update; then, once ALL
drones have stepped, the cylinder-manifold drone-drone contact: each thread
computes every pair its drone belongs to, in the pair's (lower, higher)
orientation, so both members get the same impulse.

Blocks are the packed column-per-(env x drone) rows of `ops/kernel_dyn.py`
and `ops/kernel_pid.py`, drone `d` of env `e` in column `e*N + d`:

    state (16, B*N)   pos3 quat4 vel3 rpy_rates3 ang_v3
    act   (4, B*N) rpm, or (12, B*N) PID setpoints (pos3 rpy3 vel3 rates3)
    pid   (9, B*N)    last_rpy3 integral_pos_e3 integral_rpy_e3 (PID only)
    last  (4, B*N)    the previous control step's rpm (drag modes only)
    -> state' (16, B*N), rpm (4, B*N) [, pid' (9, B*N)] [, obs12 (12, B*N)]

The TPU kernel takes drone-major (N*k, B) rows, which its wrapper builds
with a transpose per leaf and undoes with a copy per output.  Here a warp
reads its columns with a stride of N floats instead (the block's other
warps use the rest of each line through L1): the outputs stay
transposed VIEWS of the kernel's blocks, and a step costs the same two
tensor operations per input as the DYN kernels' wrappers (one `cat`, one
transposing copy) and none per output.

What bounds it on an H100: operations.  A drone substep needs around 3,000
float32 operations (the contact solve alone holds 12 effective masses and
4 sweeps x 4 points x 3 directions) against some 60 floats moved per drone
and control step, so the operation bound exceeds the byte bound, and the
dependent chain of one thread — not either bound — sets the time.  The
design shortens that chain: one drone's state, rpm and stale rpm in
registers (no array is indexed at run time, so nothing sits in local
memory), each pair computed by both of its members (N-1 pairs on a thread's
chain instead of N(N-1)/2), and 32 envs a block, so 4096 envs fill 128
blocks.  The loops over substeps, sweeps and partners stay rolled; the 4 rim
points, the 2 tangents and the obstacle table (up to its capacity of 8) are
unrolled.  The sweep count is a run-time value of the parameter struct: any
`solver_iterations` that `envs/core.step` takes runs through the kernel as
well (the TPU kernel unrolls exactly 4 and sends other values down another
path).

Arithmetic order is the TPU kernel's, not `ops/rigid_body.py`'s: the world
inverse inertia is applied as R (J^-1 (R^T v)); each drone adds its pair
impulses in the order of a loop over unordered pairs (i, j), i < j, with
`-imp` to the partner.

`pyb_substep_rows` / `env_ctrl_step_plain` are the same row arithmetic in
plain PyTorch.  The wrapper uses them only for tensors that lie on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.control import dsl_pid as C
from gym_pybullet_drones_tpu_torch.ops import (
    kernel_dyn, kernel_math, kernel_pid)
from gym_pybullet_drones_tpu_torch.ops.kernel_dyn import S, check_rows
from gym_pybullet_drones_tpu_torch.ops.kernel_pid import PR, TR
from gym_pybullet_drones_tpu_torch.ops.rigid_body import (
    ANGULAR_DAMPING, CONTACT_ERP, CONTACT_SLOP, GROUND_FRICTION,
    LINEAR_DAMPING, SOLVER_ITERATIONS, _prop_coef_pairs)
from gym_pybullet_drones_tpu_torch.params import DroneParams
from gym_pybullet_drones_tpu_torch.utils import graphs
from gym_pybullet_drones_tpu_torch.utils.enums import DroneModel, Physics

GND_MODES = (Physics.PYB_GND, Physics.PYB_GND_DRAG_DW)
DRAG_MODES = (Physics.PYB_DRAG, Physics.PYB_GND_DRAG_DW)
DW_MODES = (Physics.PYB_DW, Physics.PYB_GND_DRAG_DW)

MAX_OBSTACLES = 8  # GPD_MAX_OBSTACLES

launches = 0  # kernel launches made by `env_ctrl_step_rows` (CUDA only)


# ---- 3-vector helpers on tuples of rows ----

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
            roll, pitch, _ = kernel_math.quat_rpy_rows(*d["q"])
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


def _cols(block: torch.Tensor, n: int, d: int):
    """Rows of drone `d` of every env from a (k, B*N) block: (k, B)."""
    return block[:, d::n]


def env_ctrl_step_plain(pid_params, dyn_params: DroneParams, physics: Physics,
                        n_drones: int, n_substeps: int, pyb_dt: float,
                        ctrl_dt: float, obstacles, state_rows, act_rows,
                        pid_rows=None, last_rpm_rows=None,
                        emit_obs12: bool = False,
                        sweeps: int = SOLVER_ITERATIONS):
    """Plain PyTorch version of the kernel on packed rows (see the module
    docstring): returns (state' (16, B*N), rpm (4, B*N), pid' (9, B*N) or
    None, obs12 (12, B*N) or None), on whatever device the inputs lie."""
    n = n_drones
    use_pid = pid_params is not None
    states, rpms, new_pids, lasts = [], [], [], []
    for d in range(n):
        st = tuple(_cols(state_rows, n, d))
        states.append(st)
        if use_pid:
            rpm, new_pid = kernel_pid.pid_tick_rows(
                pid_params, ctrl_dt, st, tuple(_cols(pid_rows, n, d)),
                tuple(_cols(act_rows, n, d)))
            new_pids.append(new_pid)
        else:
            rpm = list(_cols(act_rows, n, d))
        rpms.append(rpm)
        if physics in DRAG_MODES:
            lasts.append(list(_cols(last_rpm_rows, n, d)))
    if physics == Physics.DYN:
        final = []
        for d in range(n):
            thrust, xt, yt, zt = kernel_dyn.motor_mix_rows(dyn_params,
                                                           *rpms[d])
            final.append(kernel_dyn.dyn_substeps_rows(
                dyn_params, n_substeps, pyb_dt, states[d][:13], thrust, xt,
                yt, zt))
    else:
        final = pyb_ctrl_step_rows(dyn_params, physics, n_substeps, pyb_dt,
                                   obstacles, states, rpms, lasts, sweeps)

    def interleave(per_drone, k):
        # per drone k rows of (B,) -> (k, B*N), drone d in columns d::n
        blk = torch.stack([torch.stack(tuple(rows)) for rows in per_drone],
                          dim=-1)                        # (k, B, N)
        return blk.reshape(k, -1)
    out = interleave(final, S)
    rpm_out = interleave(rpms, 4)
    pid_out = interleave(new_pids, PR) if use_pid else None
    obs12 = None
    if emit_obs12:
        rows12 = []
        for f in final:
            roll, pitch, yaw = kernel_math.quat_rpy_rows(*f[3:7])
            rows12.append(tuple(f[0:3]) + (roll, pitch, yaw) + tuple(f[7:10])
                          + tuple(f[13:16]))
        obs12 = interleave(rows12, 12)
    return out, rpm_out, pid_out, obs12


# ---- the kernel's parameter struct ----

def _fill_axis(axis, coefs, kf: float) -> None:
    pairs, left = _prop_coef_pairs(coefs)
    axis.n_pairs, axis.n_left = len(pairs), len(left)
    for k, (i, j, c) in enumerate(pairs):
        axis.pair_i[k], axis.pair_j[k], axis.pair_c[k] = i, j, c * kf
    for k, i in enumerate(left):
        axis.left_i[k], axis.left_c[k] = i, coefs[i] * kf


def fill_pyb_params(sp: _build.StepParams, params: DroneParams,
                    physics: Physics, dt: float, obstacles,
                    sweeps: int) -> None:
    """Write the physics mode, the PYB drone constants, the derived
    constants, the sweep count and the obstacle table into a kernel
    parameter struct.  Every constant is computed in double precision and
    rounded once to float32, as a Python float is when it meets a float32
    tensor in the plain version."""
    y = sp.pyb
    y.enabled = int(physics != Physics.DYN)
    y.gnd, y.drag, y.dw = (int(physics in m)
                           for m in (GND_MODES, DRAG_MODES, DW_MODES))
    if sweeps < 0:
        raise ValueError("solver_iterations must not be negative")
    if len(obstacles) > MAX_OBSTACLES:
        raise ValueError(f"the kernels take at most {MAX_OBSTACLES} "
                         f"obstacles, got {len(obstacles)}")
    y.sweeps, y.n_obstacles = sweeps, len(obstacles)
    offs = params.prop_offsets
    _fill_axis(y.tau_x, [offs[i][1] for i in range(4)], params.kf)
    _fill_axis(y.tau_y, [-offs[i][0] for i in range(4)], params.kf)
    for i in range(4):
        y.prop_x[i], y.prop_y[i] = offs[i][0], offs[i][1]
    y.m, y.two_inv_m = params.m, 2.0 * (1.0 / params.m)
    y.gnd_eff_coeff, y.gnd_eff_h_clip = (params.gnd_eff_coeff,
                                         params.gnd_eff_h_clip)
    y.prop_radius = params.prop_radius
    for k in range(3):
        y.neg_drag_c[k] = -params.drag_coeff[k]
    y.rpm_to_rad = 2.0 * math.pi / 60.0
    y.dw1, y.dw2, y.dw3 = (params.dw_coeff_1, params.dw_coeff_2,
                           params.dw_coeff_3)
    y.lin_damp = (1.0 - LINEAR_DAMPING) ** dt
    y.ang_damp = (1.0 - ANGULAR_DAMPING) ** dt
    y.erp_dt, y.inv_dt = CONTACT_ERP / dt, 1.0 / dt
    y.mu, y.slop = GROUND_FRICTION, CONTACT_SLOP
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    y.rc, y.z_lo, y.z_hi, y.min_d = rc, zoff - h2, zoff + h2, 2.0 * rc
    for e, entry in enumerate(obstacles):
        if len(entry) not in (4, 6):
            raise ValueError("an obstacle is (x, y, z, radius) or "
                             "(x, y, z, hx, hy, hz)")
        y.obs_kind[e] = int(len(entry) == 6)
        vals = list(entry)
        # the sums with the body radius, rounded once from double
        vals += [entry[3] + rc] if len(entry) == 4 \
            else [entry[3] + rc, entry[4] + rc, entry[5] + rc]
        for k, val in enumerate(vals):
            y.obs[e][k] = val


@functools.lru_cache(maxsize=32)
def _step_params(pid_params, dyn_params: DroneParams, physics: Physics,
                 n_drones: int, n_substeps: int, pyb_dt: float,
                 ctrl_dt: float, obstacles: tuple,
                 sweeps: int) -> _build.StepParams:
    sp = _build.StepParams()
    kernel_dyn.fill_drone_params(sp, dyn_params, n_substeps, pyb_dt)
    if pid_params is not None:
        kernel_pid.fill_pid_params(sp, pid_params, ctrl_dt)
    fill_pyb_params(sp, dyn_params, physics, pyb_dt, obstacles, sweeps)
    sp.n_drones = n_drones
    return sp


def env_ctrl_step_rows(pid_params, dyn_params: DroneParams, physics: Physics,
                       n_drones: int, n_substeps: int, pyb_dt: float,
                       ctrl_dt: float, obstacles: tuple,
                       state_rows: torch.Tensor, act_rows: torch.Tensor,
                       pid_rows: torch.Tensor | None = None,
                       last_rpm_rows: torch.Tensor | None = None,
                       emit_obs12: bool = False,
                       sweeps: int = SOLVER_ITERATIONS):
    """The kernel's wrapper on packed rows: state (16, B*N), act (4, B*N)
    rpm or (12, B*N) setpoints with `pid_rows` (9, B*N), `last_rpm_rows`
    (4, B*N) for the drag modes -> (state' (16, B*N), rpm (4, B*N), pid'
    (9, B*N) or None, obs12 (12, B*N) or None).

    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation; outputs from `torch.empty`); a CPU tensor runs
    `env_ctrl_step_plain`.  Anything the kernel does not take raises.
    The launch goes through `utils.graphs.launch`.
    """
    use_pid = pid_params is not None
    drag = physics in DRAG_MODES
    check_rows("state_rows", state_rows, S)
    check_rows("act_rows", act_rows, TR if use_pid else 4, like=state_rows)
    if use_pid:
        check_rows("pid_rows", pid_rows, PR, like=state_rows)
        if pid_params.model not in (DroneModel.CF2X, DroneModel.CF2P):
            raise ValueError(
                "the DSL-PID needs a CF2X or CF2P controller model")
    if drag:
        check_rows("last_rpm_rows", last_rpm_rows, 4, like=state_rows)
    if n_substeps < 1:
        raise ValueError("n_substeps must be at least 1")
    if not 1 <= n_drones <= _build.MAX_DRONES:
        raise ValueError(f"the kernel takes 1..{_build.MAX_DRONES} drones")
    bn = state_rows.shape[1]
    if bn % n_drones:
        raise ValueError(f"{bn} columns do not hold envs of {n_drones}")
    sp = _step_params(pid_params, dyn_params, physics, n_drones, n_substeps,
                      pyb_dt, ctrl_dt, tuple(obstacles), sweeps)
    if state_rows.device.type == "cpu":
        return env_ctrl_step_plain(
            pid_params, dyn_params, physics, n_drones, n_substeps, pyb_dt,
            ctrl_dt, obstacles, state_rows, act_rows, pid_rows,
            last_rpm_rows, emit_obs12, sweeps)
    if state_rows.device.type != "cuda":
        raise ValueError(f"unsupported device {state_rows.device}")
    fn = _build.load()["env_ctrl_step"]
    new = lambda rows: torch.empty((rows, bn), dtype=torch.float32,
                                   device=state_rows.device)
    out, rpm_out = new(S), new(4)
    pid_out = new(PR) if use_pid else None
    obs12 = new(12) if emit_obs12 else None
    ptr = lambda t: None if t is None else t.data_ptr()

    def go():
        global launches
        with torch.cuda.device(state_rows.device):
            err = fn(state_rows.data_ptr(), act_rows.data_ptr(),
                     ptr(pid_rows if use_pid else None),
                     ptr(last_rpm_rows if drag else None), out.data_ptr(),
                     rpm_out.data_ptr(), ptr(pid_out), ptr(obs12),
                     bn // n_drones, state_rows.stride(0), ctypes.byref(sp),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"env_ctrl_step launch failed: CUDA error {err}")
        launches += 1
    graphs.launch(go)
    return out, rpm_out, pid_out, obs12


def env_ctrl_step(pid_params, dyn_params: DroneParams, physics: Physics,
                  n_drones: int, n_substeps: int, pyb_dt: float,
                  ctrl_dt: float, obstacles: tuple, state, ctrl_state,
                  action_rows, last_rpm, emit_obs12: bool = False,
                  solver_iterations: int = SOLVER_ITERATIONS):
    """Fused control step over B envs of N drones, in one kernel launch.

    state: NamedTuple with pos/quat/vel/rpy_rates/ang_v leaves of shape
    (B*N, k), drone d of env e in row e*N + d; ctrl_state: dsl_pid.PIDState
    with (B*N, 3) leaves (pass None when pid_params is None); action_rows:
    (B*N, 12) PID targets when pid_params is set, else (B*N, 4) rpm;
    last_rpm: (B*N, 4) (consumed by the drag modes).  Returns (state',
    ctrl_state', rpm) plus the in-kernel (B*N, 12) kinematic obs block when
    emit_obs12; the returned leaves are views of the kernel's row blocks.
    `solver_iterations` is the contact solver's sweep count, any value.
    """
    use_pid = pid_params is not None
    rows = lambda x: x.t().contiguous()
    pid_rows = rows(torch.cat(
        [ctrl_state.last_rpy, ctrl_state.integral_pos_e,
         ctrl_state.integral_rpy_e], dim=-1)) if use_pid else None
    last_rows = rows(last_rpm) if physics in DRAG_MODES else None
    out, rpm, pid_out, obs12 = env_ctrl_step_rows(
        pid_params, dyn_params, physics, n_drones, n_substeps, pyb_dt,
        ctrl_dt, obstacles, kernel_dyn._pack(state), rows(action_rows),
        pid_rows, last_rows, emit_obs12, solver_iterations)
    new_ctrl = ctrl_state
    if use_pid:
        p = pid_out.t()
        new_ctrl = C.PIDState(last_rpy=p[:, 0:3], integral_pos_e=p[:, 3:6],
                              integral_rpy_e=p[:, 6:9])
    res = (kernel_dyn._unpack(out, state), new_ctrl, rpm.t())
    return res + (obs12.t(),) if emit_obs12 else res
