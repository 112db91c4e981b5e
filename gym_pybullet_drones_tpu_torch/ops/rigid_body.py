"""Bullet-style rigid-body integrator with impulse-based contact (PYB mode).

Counterpart of the JAX package's `ops/rigid_body.py`: a stand-in for the
Bullet engine the reference drives through `p.stepSimulation` (reference
BaseAviary.py:369-370) that follows Bullet's documented discrete algorithm:

- external prop forces applied at prop link positions (LINK frame semantics
  of p.applyExternalForce, reference BaseAviary.py:679-711) => world force
  R @ f and torque (R @ offset) x (R @ f) about the CoM,
- velocity update with gravity AND the gyroscopic bias term
  w_b x (J w_b),
- Bullet-style velocity damping v *= (1-d)^dt with PyBullet's URDF default
  d = 0.04 (linear and angular),
- contact detected on the PRE-step pose (Bullet runs collision detection at
  the start of stepSimulation), resolved by a projected Gauss-Seidel
  impulse solve with accumulated-impulse clamping:
    * normal impulse >= 0 with Baumgarte penetration correction
      v_n_target = (ERP/dt) * penetration (ERP = 0.2, restitution 0);
      separated points within CONTACT_SLOP join speculatively with the
      closing-velocity limit gap/dt, so fast approaches stop at the surface,
    * two tangential friction impulses each clamped to the Coulomb cone
      |j_t| <= mu * j_n with mu = 0.5,
    * the ground manifold is 4 points on the bottom rim of the collision
      cylinder, giving physical lever arms: a tilted lander rights itself,
- then semi-implicit position integration x += dt v and quaternion update by
  the world-angular-velocity exponential map.

State layout matches DynState but `ang_v` (world angular velocity) is the
carry, as in Bullet.  General dtype with leading batch dimensions written
out; this is the tensor path (`envs/core.step`).  The float32 rollout runs
the same physics inside the kernel of `ops/kernel_env.py`, whose arithmetic
order differs in two places: it applies the world inverse inertia as
R (J^-1 (R^T v)) where this module builds the matrix R diag(J^-1) R^T, and
it accumulates each unordered drone pair once where this module sums the
ordered pairs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.params import DroneParams
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops
from gym_pybullet_drones_tpu_torch.ops.dynamics import motor_forces_torques

# PyBullet defaults for URDF-loaded bodies (changeDynamics docs)
LINEAR_DAMPING = 0.04
ANGULAR_DAMPING = 0.04
GROUND_FRICTION = 0.5     # lateral_friction default; no <contact> tag in URDFs
CONTACT_ERP = 0.2         # PyBullet contactERP default
SOLVER_ITERATIONS = 4     # PGS sweeps (island of <= 7 constraints: converged)
CONTACT_SLOP = 0.02       # speculative-contact window (Bullet's
#                           gContactBreakingThreshold): separated points
#                           within this gap join the solve with the
#                           closing-velocity limit gap/dt


class PybState(NamedTuple):
    pos: torch.Tensor    # (..., 3)
    quat: torch.Tensor   # (..., 4) xyzw
    vel: torch.Tensor    # (..., 3) world linear velocity
    ang_v: torch.Tensor  # (..., 3) world angular velocity


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


def _paired_prop_torque(params: DroneParams, rpm, coefs):
    """sum_i coefs[i] * kf * rpm_i^2 with exact symmetric cancellation:
    paired terms are computed as (r_i-r_j)(r_i+r_j) * (c*kf)."""
    pairs, left = _prop_coef_pairs(coefs)
    out = torch.zeros(rpm.shape[:-1], dtype=rpm.dtype, device=rpm.device)
    for i, j, c in pairs:
        ri, rj = rpm[..., i], rpm[..., j]
        out = out + ((ri - rj) * (ri + rj)) * (c * params.kf)
    for i in left:
        out = out + (rpm[..., i] * rpm[..., i]) * (coefs[i] * params.kf)
    return out


def _ground_manifold(params: DroneParams, pos, rot):
    """4-point contact manifold on the bottom rim of the collision cylinder.

    Returns (arms, penetrations): world-frame arms r_k from the CoM to each
    candidate contact point (..., 4, 3) and the signed penetration depth of
    each point below the z=0 plane (..., 4), positive = penetrating.
    """
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    # body-frame rim points at 0/90/180/270 deg on the bottom disk
    rim = torch.tensor([[rc, 0.0, zoff - h2],
                        [0.0, rc, zoff - h2],
                        [-rc, 0.0, zoff - h2],
                        [0.0, -rc, zoff - h2]], dtype=pos.dtype,
                       device=pos.device)                      # (4, 3)
    arms = torch.einsum("...ij,kj->...ki", rot, rim)           # (..., 4, 3)
    pen = -(pos[..., None, 2] + arms[..., 2])                  # (..., 4)
    return arms, pen


def _unit_like(arms: torch.Tensor, axis: int) -> torch.Tensor:
    out = torch.zeros_like(arms)
    out[..., axis] = 1.0
    return out


def _solve_contacts(params: DroneParams, rot, vel, ang_v, arms, pen,
                    mu: float, dt, extra=(),
                    iterations: int = SOLVER_ITERATIONS):
    """Projected Gauss-Seidel impulse solve for one body vs static geometry.

    arms: (..., K, 3) world arms to contact points, pen: (..., K) depths
    for plane contacts with normal +z.  `extra` is a sequence of
    (normal, penetration) pairs for centered contacts (arm = 0, e.g.
    bounding-sphere obstacle hits) that join the same solve.

    Bullet-style speculative contacts: a point is active when its depth
    exceeds -CONTACT_SLOP; the normal velocity target is ERP/dt * depth
    when penetrating (Baumgarte push-out) and depth/dt when separated.
    Returns updated (vel, ang_v).
    """
    dtype, device = vel.dtype, vel.device
    inv_m = 1.0 / params.m
    j_inv_diag = torch.tensor(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz], dtype=dtype,
        device=device)
    # world inverse inertia as an explicit matrix, R diag(J^-1) R^T
    i_inv = torch.einsum("...ik,k,...jk->...ij", rot, j_inv_diag, rot)

    def iinv(v):
        return torch.einsum("...ij,...j->...i", i_inv, v)

    cross = torch.linalg.cross
    beta = CONTACT_ERP / dt
    inv_dt = 1.0 / dt
    k = arms.shape[-2]
    n = _unit_like(arms, 2)                                     # (..., K, 3)
    t1 = _unit_like(arms, 0)
    t2 = _unit_like(arms, 1)
    active = (pen > -CONTACT_SLOP).to(dtype)                    # (..., K)

    # effective masses (constant through the solve): 1/m + ((I^-1 (r x d))
    # x r) . d for each constraint direction d
    def keff(d):
        rxd = cross(arms, d)
        return inv_m + torch.sum(cross(
            torch.einsum("...ij,...kj->...ki", i_inv, rxd), arms) * d,
            dim=-1)
    kn, kt1, kt2 = keff(n), keff(t1), keff(t2)

    # speculative target: push out when penetrating, allow closing to the
    # surface when separated
    target = torch.where(pen > 0, beta * pen, inv_dt * pen)     # (..., K)
    e_active = [(ep > -CONTACT_SLOP).to(dtype) for _, ep in extra]
    e_target = [torch.where(ep > 0, beta * ep, inv_dt * ep)
                for _, ep in extra]

    zero_k = torch.zeros_like(pen)
    acc_n = [zero_k[..., ki] for ki in range(k)]
    acc_t = [[zero_k[..., ki] for ki in range(k)] for _ in range(2)]
    extra_acc = [torch.zeros_like(ep) for _, ep in extra]
    extra_t = [torch.zeros_like(ep) for _, ep in extra]
    for _ in range(iterations):
        for ki in range(k):
            r = arms[..., ki, :]
            a = active[..., ki]
            # normal
            v_c = vel + cross(ang_v, r)
            vn = v_c[..., 2]
            dj = (target[..., ki] - vn) / kn[..., ki]
            new_acc = torch.clamp(acc_n[ki] + dj, min=0.0) * a
            dj = new_acc - acc_n[ki]
            acc_n[ki] = new_acc
            imp = dj[..., None] * n[..., ki, :]
            vel = vel + inv_m * imp
            ang_v = ang_v + iinv(cross(r, imp))
            # friction (both tangents), cone clamped by accumulated normal
            lim = mu * acc_n[ki]
            for which, (tdir, kt) in enumerate(((t1, kt1), (t2, kt2))):
                v_c = vel + cross(ang_v, r)
                vt = torch.sum(v_c * tdir[..., ki, :], dim=-1)
                dj = -vt / kt[..., ki]
                new_acc = torch.minimum(
                    torch.maximum(acc_t[which][ki] + dj, -lim), lim) * a
                dj = new_acc - acc_t[which][ki]
                acc_t[which][ki] = new_acc
                imp = dj[..., None] * tdir[..., ki, :]
                vel = vel + inv_m * imp
                ang_v = ang_v + iinv(cross(r, imp))
        # centered extra contacts (arm = 0: no angular coupling)
        for ei, (en, _) in enumerate(extra):
            a = e_active[ei]
            vn = torch.sum(vel * en, dim=-1)
            dj = (e_target[ei] - vn) * params.m
            new_acc = torch.clamp(extra_acc[ei] + dj, min=0.0) * a
            dj = new_acc - extra_acc[ei]
            extra_acc[ei] = new_acc
            vel = vel + (dj * inv_m)[..., None] * en
            # friction in the contact plane (linear only), with the
            # ACCUMULATED tangential impulse clamped to the Coulomb cone
            # mu * acc_n
            vt = vel - torch.sum(vel * en, dim=-1)[..., None] * en
            vt_norm = torch.linalg.norm(vt, dim=-1)
            j_stop = vt_norm * params.m                  # impulse to stop
            new_t = torch.minimum(extra_t[ei] + j_stop, mu * new_acc) * a
            dj_t = torch.clamp(new_t - extra_t[ei], min=0.0)
            extra_t[ei] = new_t
            lim_v = dj_t * inv_m                         # velocity units
            scale = torch.where(vt_norm > 1e-9,
                                torch.clamp(vt_norm - lim_v, min=0.0)
                                / torch.clamp(vt_norm, min=1e-9), 1.0)
            scale = torch.where(a > 0, scale, 1.0)
            vel = vt * scale[..., None] + (vel - vt)
    return vel, ang_v


def obstacle_contact(entry, pos: torch.Tensor, body_r: float):
    """(unit normal (..., 3), depth (...,)) of one static obstacle against a
    body of bounding radius `body_r` centred at `pos`.

    entry: (x, y, z, radius) = sphere, (x, y, z, hx, hy, hz) = axis-aligned
    box (centre + half extents).  Inside a box the normal is the face of
    least penetration, the first minimum over x, y, z.
    """
    dtype, device = pos.dtype, pos.device
    center = torch.tensor(entry[0:3], dtype=dtype, device=device)
    if len(entry) == 4:
        delta = pos - center
        dist = torch.linalg.norm(delta, dim=-1)
        n_hat = delta / torch.clamp(dist, min=1e-6)[..., None]
        return n_hat, entry[3] + body_r - dist
    half = torch.tensor(entry[3:6], dtype=dtype, device=device)
    rel = pos - center
    closest = torch.minimum(torch.maximum(rel, -half), half)
    delta = rel - closest                 # 0 inside the box
    dist = torch.linalg.norm(delta, dim=-1)
    outside = dist > 1e-6
    n_out = delta / torch.clamp(dist, min=1e-6)[..., None]
    pen_ax = half + body_r - torch.abs(rel)               # (..., 3)
    axis_1h = torch.nn.functional.one_hot(
        torch.argmin(pen_ax, dim=-1), 3).to(dtype)
    sgn = torch.where(rel >= 0, 1.0, -1.0)
    n_in = axis_1h * sgn
    n_hat = torch.where(outside[..., None], n_out, n_in)
    depth = torch.where(outside, body_r - dist,
                        torch.min(pen_ax, dim=-1).values)
    return n_hat, depth


def pyb_step(params: DroneParams, state: PybState, rpm: torch.Tensor,
             dt: float,
             ext_force: torch.Tensor | None = None,
             ext_torque: torch.Tensor | None = None,
             obstacles: tuple = (),
             solver_iterations: int = SOLVER_ITERATIONS) -> PybState:
    """One physics substep of the Bullet-like integrator.

    ext_force / ext_torque are additional world-frame force/torque about the
    CoM (the aero effects from ops/aero.py), already composed by the caller
    according to the active Physics mode.  `solver_iterations` takes any
    sweep count (PyBullet's own default is 50).
    """
    dtype, device = state.pos.dtype, state.pos.device
    rot = quat_ops.quat_to_mat(state.quat)             # (..., 3, 3)
    # per-motor thrusts + z-torque with model-dependent sign (reference
    # BaseAviary.py:693-697)
    forces, mix_torques = motor_forces_torques(params, rpm)
    z_torque = mix_torques[..., 2]

    # World force: sum of per-prop thrusts along the body z axis.
    z_axis = rot[..., :, 2]
    total_thrust = torch.sum(forces, dim=-1)
    force_w = z_axis * total_thrust[..., None]
    # Torque about CoM from per-prop application points: R @ (off x [0,0,f])
    if dtype == torch.float64:   # parity-oracle path: cross-product order
        offsets = torch.tensor(params.prop_offsets, dtype=dtype,
                               device=device)                     # (4, 3)
        f_body = torch.zeros(forces.shape + (3,), dtype=dtype, device=device)
        f_body[..., 2] = forces                                   # (...,4,3)
        tau_body = torch.sum(
            torch.linalg.cross(offsets.expand_as(f_body), f_body), dim=-2)
        tau_body = torch.cat(
            [tau_body[..., :2], (tau_body[..., 2] + z_torque)[..., None]],
            dim=-1)
    else:
        # f32 production path: pair props with opposite-equal offset
        # coefficients and compute each pair as (r_i-r_j)(r_i+r_j)*(c*kf) —
        # exact zero for bitwise-equal rpms under any FMA contraction
        tau_x = _paired_prop_torque(
            params, rpm, [o[1] for o in params.prop_offsets])
        tau_y = _paired_prop_torque(
            params, rpm, [-o[0] for o in params.prop_offsets])
        tau_body = torch.stack([tau_x, tau_y, z_torque], dim=-1)
    torque_w = torch.einsum("...ij,...j->...i", rot, tau_body)

    if ext_force is not None:
        force_w = force_w + ext_force
    if ext_torque is not None:
        torque_w = torque_w + ext_torque

    # Gravity + velocity update with the gyroscopic bias term
    # (Featherstone: dw_b = J^-1 (tau_b - w_b x (J w_b)))
    acc = force_w / params.m
    gravity = torch.zeros_like(acc)
    gravity[..., 2] = 9.8
    acc = acc - gravity
    vel = state.vel + dt * acc
    j_diag = torch.tensor([params.ixx, params.iyy, params.izz], dtype=dtype,
                          device=device)
    j_inv = 1.0 / j_diag
    tau_b = torch.einsum("...ji,...j->...i", rot, torque_w)       # R^T tau
    w_b = torch.einsum("...ji,...j->...i", rot, state.ang_v)
    tau_b = tau_b - torch.linalg.cross(w_b, j_diag * w_b)
    dw_b = j_inv * tau_b
    ang_v = state.ang_v + dt * torch.einsum("...ij,...j->...i", rot, dw_b)

    # Bullet-style damping (applied after velocity integration)
    vel = vel * (1.0 - LINEAR_DAMPING) ** dt
    ang_v = ang_v * (1.0 - ANGULAR_DAMPING) ** dt

    # --- Contact solve on the PRE-step pose (Bullet collision order) ---
    arms, pen = _ground_manifold(params, state.pos, rot)
    # static obstacles as centered bounding-sphere contacts (no angular term)
    extra = [obstacle_contact(entry, state.pos, params.collision_r)
             for entry in obstacles]
    vel, ang_v = _solve_contacts(params, rot, vel, ang_v, arms, pen,
                                 GROUND_FRICTION, dt, extra,
                                 iterations=solver_iterations)

    # --- Position integration with the corrected velocities ---
    pos = state.pos + dt * vel
    # Bullet integrates orientation with the world angular velocity
    # (left-multiplied exponential map — NOT the body-rate variant)
    quat = quat_ops.integrate_quat_world(state.quat, ang_v, dt)
    return PybState(pos=pos, quat=quat, vel=vel, ang_v=ang_v)


def resolve_drone_collisions(params: DroneParams, pos: torch.Tensor,
                             vel: torch.Tensor, dt: float | None = None,
                             quat: torch.Tensor | None = None,
                             ang_v: torch.Tensor | None = None):
    """Pairwise drone-drone contact within one env.

    Counterpart of Bullet's multibody contact between drone collision shapes
    (the reference loads every drone into one PyBullet world,
    BaseAviary.py:484-491, so bodies collide in all PYB* modes).

    With ``quat``/``ang_v`` provided (the production path), each pair whose
    center distance is inside the sphere-swept window (< 2 * collision_r +
    slop) is resolved as a cylinder-manifold contact with full angular
    response:

    - the contact point is the midpoint of the two bodies' cylinder-clamped
      closest points toward the pair midpoint, so tilted or height-offset
      drones contact off their center line and the normal impulse exerts
      torque;
    - the normal is the center line (j -> i) with the same speculative
      Baumgarte target as the ground solve (ERP = 0.2, restitution 0);
    - a single Coulomb friction impulse opposes the tangential relative
      velocity at the contact point, clamped to ``mu * j_n``;
    - impulses use the full two-body effective mass; one Jacobi pass over
      ordered pairs, antisymmetric by construction, so linear momentum is
      conserved up to the Baumgarte bias.

    Returns ``(pos, vel, ang_v)``.  Without ``quat`` the legacy
    bounding-sphere centered response is used (no angular term; returns
    ``(pos, vel)``).  pos/vel/ang_v are (..., N, 3), quat (..., N, 4).
    """
    dtype, device = pos.dtype, pos.device
    n = pos.shape[-2]
    if n < 2:
        return (pos, vel) if quat is None else (pos, vel, ang_v)
    cross = torch.linalg.cross
    min_d = 2.0 * params.collision_r
    beta = 0.0 if dt is None else CONTACT_ERP / dt
    inv_dt = 0.0 if dt is None else 1.0 / dt
    diff = pos[..., :, None, :] - pos[..., None, :, :]     # d[i,j] = p_i - p_j
    dist = torch.linalg.norm(diff, dim=-1)                 # (..., N, N)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    depth = min_d - dist                                   # + = penetrating
    hit = (depth > -CONTACT_SLOP) & ~eye & (dist > 1e-6)
    n_hat = diff / torch.clamp(dist, min=1e-6)[..., None]
    rel_v = vel[..., :, None, :] - vel[..., None, :, :]
    target = torch.where(depth > 0, beta * depth, inv_dt * depth)

    if quat is None:
        # legacy centered response: normal impulse split between the two
        # equal-mass bodies, no angular coupling
        vn = torch.sum(rel_v * n_hat, dim=-1)              # (..., N, N)
        dv_pair = torch.clamp(target - vn, min=0.0)        # only push apart
        dv = torch.sum(
            torch.where(hit[..., None], 0.5 * dv_pair[..., None] * n_hat,
                        0.0), dim=-2)
        return pos, vel + dv

    rot = quat_ops.quat_to_mat(quat)                       # (..., N, 3, 3)
    inv_m = 1.0 / params.m
    j_inv_diag = torch.tensor(
        [1.0 / params.ixx, 1.0 / params.iyy, 1.0 / params.izz], dtype=dtype,
        device=device)
    i_inv = torch.einsum("...ik,k,...jk->...ij", rot, j_inv_diag, rot)

    # contact point: midpoint of the two cylinder-clamped closest points
    rc, h2 = params.collision_r, params.collision_h / 2
    zoff = params.collision_z_offset
    mid = 0.5 * (pos[..., :, None, :] + pos[..., None, :, :])  # (..N,N,3)

    def surf_point(body_axis):
        # clamp `mid` into the cylinder of the body indexed on `body_axis`
        if body_axis == 0:        # body i: rows
            c = pos[..., :, None, :]
            r_mat = rot[..., :, None, :, :]
        else:                     # body j: cols
            c = pos[..., None, :, :]
            r_mat = rot[..., None, :, :, :]
        u = torch.einsum("...ba,...b->...a", r_mat, mid - c)   # R^T (mid-c)
        ur = torch.sqrt(u[..., 0] ** 2 + u[..., 1] ** 2)
        s = torch.clamp(rc / torch.clamp(ur, min=1e-9), max=1.0)
        q = torch.stack([u[..., 0] * s, u[..., 1] * s,
                         torch.clamp(u[..., 2], zoff - h2, zoff + h2)],
                        dim=-1)
        return c + torch.einsum("...ab,...b->...a", r_mat, q)
    pc = 0.5 * (surf_point(0) + surf_point(1))             # (..., N, N, 3)
    r_i = pc - pos[..., :, None, :]
    r_j = pc - pos[..., None, :, :]

    w_i = ang_v[..., :, None, :].expand_as(r_i)
    w_j = ang_v[..., None, :, :].expand_as(r_j)
    i_inv_i = i_inv[..., :, None, :, :]
    i_inv_j = i_inv[..., None, :, :, :]
    rel_c = rel_v + cross(w_i, r_i) - cross(w_j, r_j)      # at contact point

    def keff(d_vec):
        rxd_i = cross(r_i, d_vec)
        rxd_j = cross(r_j, d_vec)
        term_i = torch.sum(cross(
            torch.einsum("...ab,...b->...a", i_inv_i, rxd_i), r_i) * d_vec,
            dim=-1)
        term_j = torch.sum(cross(
            torch.einsum("...ab,...b->...a", i_inv_j, rxd_j), r_j) * d_vec,
            dim=-1)
        return 2.0 * inv_m + term_i + term_j

    vn = torch.sum(rel_c * n_hat, dim=-1)                  # (..., N, N)
    j_n = torch.clamp(target - vn, min=0.0) / keff(n_hat)
    j_n = torch.where(hit, j_n, 0.0)

    # Coulomb friction along the tangential relative velocity
    vt = rel_c - vn[..., None] * n_hat
    vt_norm = torch.linalg.norm(vt, dim=-1)
    t_hat = vt / torch.clamp(vt_norm, min=1e-9)[..., None]
    j_t = torch.minimum(vt_norm / keff(t_hat), GROUND_FRICTION * j_n)
    j_t = torch.where(hit, j_t, 0.0)

    imp = j_n[..., None] * n_hat - j_t[..., None] * t_hat  # on body i
    dv = torch.sum(imp, dim=-2) * inv_m
    dw = torch.sum(torch.einsum("...ab,...b->...a", i_inv_i,
                                cross(r_i, imp)), dim=-2)
    return pos, vel + dv, ang_v + dw
