// Shared device functions and the parameter struct of the drone kernels.
//
// The per-column arithmetic lives here once: the motor mixer, the explicit
// DYN substeps, the Euler extraction, the cascaded DSL-PID tick with its
// setpoints, one drone's PYB-family substep, one drone-drone contact pair,
// one downwash term, and the Hover / MultiHover / Routing task shares.
// dyn_ctrl_step.cu, pid_dyn_ctrl_step.cu, env_ctrl_step.cu and
// fused_env_step.cu are thin __global__ shells around these functions.
// Everything is float32 and written as GPD_HD functions (plain `inline`
// without nvcc), so the same bodies can be compiled for the host.
//
// The one block-level function, gpd_pyb_ctrl_substeps (the coupled PYB
// substeps of one drone of a block whose warp w holds drone w of 32 envs,
// exchanging poses through shared memory), meets the other threads of its
// block at barriers, GPD_SYNC(): __syncthreads() under nvcc.  A host build
// of it defines GPD_SYNC() and the CUDA qualifiers itself.
//
// Formulas mirror the plain PyTorch versions in ops/kernel_dyn.py,
// ops/kernel_pid.py, ops/kernel_env.py, ops/kernel_math.py, envs/tasks.py
// and envs/routing.py line by line; change them together.
#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define GPD_HD __host__ __device__ __forceinline__
#define GPD_SYNC() __syncthreads()
#else
#define GPD_HD inline
#endif

#define GPD_MAX_DRONES 8
#define GPD_MAX_OBSTACLES 8
#define GPD_S 16   // state rows per drone
#define GPD_PS 13  // live PYB state per drone: pos3 quat4 vel3 world ang-vel3
#define GPD_LR 4   // last-rpm rows per drone
#define GPD_PR 9   // embedded-PID carry rows per drone (PID-family actions)
#define GPD_TR 12  // PID setpoint rows: target pos, rpy, vel, rpy rates
#define GPD_ENVS 32  // envs per block: warp w of a block is drone w of them
// Threads per block of dyn_ctrl_step and pid_dyn_ctrl_step, one column
// each (PERF.md: 32 / 64 / 128 measured, scripts/dyn_launch_sweep.py).
#define GPD_DYN_THREADS 64

enum {
    GPD_ACT_RPM = 0, GPD_ACT_ONE_D_RPM = 1,
    // the PID family: an embedded DSL-PID turns a setpoint into rpm
    GPD_ACT_PID = 2, GPD_ACT_VEL = 3, GPD_ACT_ONE_D_PID = 4
};
enum { GPD_TASK_HOVER = 0, GPD_TASK_MULTIHOVER = 1, GPD_TASK_ROUTING = 2 };

// Constants of one drone model, each rounded once from double.
struct GpdDrone {
    float kf;         // thrust coefficient
    float km_s;       // torque coefficient, negated for the racer
    float k_arm;      // kf*l (plus mixer) or kf*l/sqrt(2) (X mixer)
    float inv_m, gm;  // 1/m, 9.8*m
    float jx, jy, jz;
    float inv_jx, inv_jy, inv_jz;
    float hover_rpm;
    int plus_mixer;   // 1 for the + configuration (CF2P)
};

// Constants of the CONTROLLER's drone model.  The env paths always pass
// CF2X here whatever `drone` is (reference BaseRLAviary.py:76).
struct GpdPid {
    float kf4;        // 4 * kf
    float gravity;    // 9.8 * m
    int plus_mixer;   // 1 for the CF2P PWM mixer
};

// One body torque axis, sum_i coef_i * kf * rpm_i^2, as paired factored
// differences (ri - rj)(ri + rj) * (c * kf) plus unpaired leftovers
// (ops/rigid_body._prop_coef_pairs).  The products with kf are rounded once.
struct GpdTorqueAxis {
    int n_pairs, n_left;
    int pair_i[2], pair_j[2], left_i[4];
    float pair_c[2], left_c[4];
};

// The PYB-family physics of one configuration (ops/kernel_env.py:
// fill_pyb_params).  Every float is computed in double and rounded once.
struct GpdPyb {
    int enabled;              // 0: explicit DYN physics
    int gnd, drag, dw;        // aero effects of the mode
    int sweeps;               // projected Gauss-Seidel sweeps
    int n_obstacles;
    GpdTorqueAxis tau_x, tau_y;
    float prop_x[4], prop_y[4];   // prop offsets in the body frame
    float m, two_inv_m;
    float gnd_eff_coeff, gnd_eff_h_clip, prop_radius;
    float neg_drag_c[3];      // -drag coefficient per world axis
    float rpm_to_rad;         // 2 pi / 60
    float dw1, dw2, dw3;      // downwash coefficients
    float lin_damp, ang_damp; // (1 - 0.04)^dt
    float erp_dt, inv_dt;     // ERP / dt, 1 / dt
    float mu, slop;           // Coulomb friction, speculative-contact window
    float rc, z_lo, z_hi;     // collision cylinder: radius, axial extent
    float min_d;              // 2 * rc
    int obs_kind[GPD_MAX_OBSTACLES];   // 0 sphere, 1 axis-aligned box
    // sphere: centre3, radius, radius + rc; box: centre3, half extents3,
    // half extents3 + rc
    float obs[GPD_MAX_OBSTACLES][9];
};

// Everything the TPU kernels folded into their program at trace time.
// Mirrored field by field by `StepParams` in _build.py.
struct GpdStepParams {
    GpdDrone drone;
    GpdPid pid;
    GpdPyb pyb;
    int n_drones, n_substeps, act_dim, buf_rows, act_type, task_id;
    int n_extra;              // task-specific obs rows per drone (routing: 6)
    int relative_actions;     // PID action is a displacement, not a goal
    int shaped;               // routing: progress + hold reward
    float dt, half_dt;        // physics step, and dt/2 rounded from double
    float ctrl_dt;            // control step
    float pyb_freq, episode_len_sec;
    float box_xy, box_z, tilt;
    float speed_limit;        // VEL actions [m/s]
    float step_size, action_scale;            // PID-action waypoints
    float arrival_tol, collision_r2;          // routing: tolerance, radius^2
    float progress_gain, arrival_hold;        // routing reward
    float init16[GPD_MAX_DRONES][GPD_S];  // per-drone reset state
    float target[GPD_MAX_DRONES][3];      // per-drone target / destination
};

// Clip that keeps a NaN a NaN, as the plain versions' clamp does.
GPD_HD float gpd_clip(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// a^2 - b^2 as a product: exactly 0 for bitwise-equal a and b whatever the
// compiler contracts into FMAs, so a symmetric hover stays symmetric.
GPD_HD float gpd_dsq(float a, float b) { return (a - b) * (a + b); }

// Per-motor rpm -> total thrust and body torques (reference
// BaseAviary.py:838-852), torques as factored squared-rpm differences.
GPD_HD void gpd_motor_mix(const GpdDrone& c, float r0, float r1, float r2,
                          float r3, float& thrust, float& xt, float& yt,
                          float& zt) {
    const float f0 = r0 * r0 * c.kf, f1 = r1 * r1 * c.kf;
    const float f2 = r2 * r2 * c.kf, f3 = r3 * r3 * c.kf;
    thrust = f0 + f1 + f2 + f3;
    zt = (gpd_dsq(r1, r0) + gpd_dsq(r3, r2)) * c.km_s;
    if (c.plus_mixer) {
        xt = gpd_dsq(r1, r3) * c.k_arm;
        yt = gpd_dsq(r2, r0) * c.k_arm;
    } else {
        xt = (gpd_dsq(r0, r2) + gpd_dsq(r1, r3)) * c.k_arm;
        yt = (gpd_dsq(r1, r0) + gpd_dsq(r2, r3)) * c.k_arm;
    }
}

// One explicit-dynamics substep on one column, state in registers.
// x = [px py pz | qx qy qz qw | vx vy vz | wx wy wz]; r receives the
// PRE-step rotation rows (row-major), which the stored world angular
// velocity reads after the last substep.
// Semantics: reference BaseAviary.py:815-889.
GPD_HD void gpd_dyn_substep(const GpdDrone& c, float dt, float half_dt,
                            float* x, float thrust, float xt, float yt,
                            float zt, float* r) {
    float px = x[0], py = x[1], pz = x[2];
    float qx = x[3], qy = x[4], qz = x[5], qw = x[6];
    float vx = x[7], vy = x[8], vz = x[9];
    float wx = x[10], wy = x[11], wz = x[12];
    // rotation matrix from the (normalized) quaternion
    const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
    const float inv_n2 = 1.0f / n2;
    const float xx = qx * qx * inv_n2, yy = qy * qy * inv_n2,
                zz = qz * qz * inv_n2;
    const float xy = qx * qy * inv_n2, xz = qx * qz * inv_n2,
                yz = qy * qz * inv_n2;
    const float wxq = qw * qx * inv_n2, wyq = qw * qy * inv_n2,
                wzq = qw * qz * inv_n2;
    r[0] = 1.0f - 2.0f * (yy + zz); r[1] = 2.0f * (xy - wzq);
    r[2] = 2.0f * (xz + wyq);
    r[3] = 2.0f * (xy + wzq); r[4] = 1.0f - 2.0f * (xx + zz);
    r[5] = 2.0f * (yz - wxq);
    r[6] = 2.0f * (xz - wyq); r[7] = 2.0f * (yz + wxq);
    r[8] = 1.0f - 2.0f * (xx + yy);

    const float fx = r[2] * thrust;
    const float fy = r[5] * thrust;
    const float fz = r[8] * thrust - c.gm;
    // tau -= w x (J w)
    const float tau_x = xt - (wy * (c.jz * wz) - wz * (c.jy * wy));
    const float tau_y = yt - (wz * (c.jx * wx) - wx * (c.jz * wz));
    const float tau_z = zt - (wx * (c.jy * wy) - wy * (c.jx * wx));

    vx = vx + dt * fx * c.inv_m;
    vy = vy + dt * fy * c.inv_m;
    vz = vz + dt * fz * c.inv_m;
    wx = wx + dt * tau_x * c.inv_jx;
    wy = wy + dt * tau_y * c.inv_jy;
    wz = wz + dt * tau_z * c.inv_jz;
    px = px + dt * vx;
    py = py + dt * vy;
    pz = pz + dt * vz;

    // exact exponential-map quaternion update (body rates); the
    // quaternion is kept as it is when ||w|| <= 1e-8.  The square root's
    // argument is raised to 1e-20 first, which keeps the quaternion all the
    // same (||w|| <= 1e-10) and keeps every other output: sqrtf of 0 (a body
    // at rest) takes the IEEE square root's slow path, which a warp holding
    // one such column waits for at every substep.  NaN stays NaN.
    const float w2 = wx * wx + wy * wy + wz * wz;
    const float norm = sqrtf(w2 < 1e-20f ? 1e-20f : w2);
    const float theta = norm * half_dt;
    // one argument reduction for both: sincosf gives sinf's and cosf's
    // values bit for bit (every float32 input, scripts/sincos_identity.py)
    float sin_theta, cth;
    sincosf(theta, &sin_theta, &cth);
    const float safe = norm > 0.0f ? norm : 1.0f;
    const float sth = sin_theta / safe;
    const float nqx = cth * qx + sth * (wz * qy - wy * qz + wx * qw);
    const float nqy = cth * qy + sth * (-wz * qx + wx * qz + wy * qw);
    const float nqz = cth * qz + sth * (wy * qx - wx * qy + wz * qw);
    const float nqw = cth * qw + sth * (-wx * qx - wy * qy - wz * qz);
    if (!(norm <= 1e-8f)) {
        qx = nqx; qy = nqy; qz = nqz; qw = nqw;
    }
    x[0] = px; x[1] = py; x[2] = pz;
    x[3] = qx; x[4] = qy; x[5] = qz; x[6] = qw;
    x[7] = vx; x[8] = vy; x[9] = vz;
    x[10] = wx; x[11] = wy; x[12] = wz;
}

// n explicit-dynamics substeps on one column, state in registers.
// s = [px py pz | qx qy qz qw | vx vy vz | wx wy wz | avx avy avz]; the
// last three are outputs only (stored world angular velocity).
//
// Runs `n_substeps` (at least 1) of the body above in a loop counted at
// run time, the last one peeled: the first n - 1 drop their rotation, the
// last one's makes the world angular velocity, once.  Unrolling the loop
// does not let consecutive substeps overlap: every IEEE division, square
// root and sine/cosine reduction is a branch region around its slow path,
// and the compiler does not schedule across those regions (PERF.md,
// scripts/dyn_launch_sweep.py), so the loop stays rolled.
GPD_HD void gpd_dyn_substeps(const GpdDrone& c, int n_substeps, float dt,
                             float half_dt, float* s, float thrust, float xt,
                             float yt, float zt) {
    float r[9];
    for (int i = 1; i < n_substeps; ++i)
        gpd_dyn_substep(c, dt, half_dt, s, thrust, xt, yt, zt, r);
    gpd_dyn_substep(c, dt, half_dt, s, thrust, xt, yt, zt, r);
    // stored world angular velocity: PRE-step rotation, post-step rates
    s[13] = r[0] * s[10] + r[1] * s[11] + r[2] * s[12];
    s[14] = r[3] * s[10] + r[4] * s[11] + r[5] * s[12];
    s[15] = r[6] * s[10] + r[7] * s[11] + r[8] * s[12];
}

// Roll/pitch/yaw of a possibly un-normalized quaternion.  atan2 is scale
// invariant, so the un-normalized quadratic terms feed it directly; the
// asin argument is divided by the squared norm and clipped (a NaN stays a
// NaN, as in the plain version's clamp).
GPD_HD void gpd_quat_rpy(float qx, float qy, float qz, float qw, float& roll,
                         float& pitch, float& yaw) {
    const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
    roll = atan2f(2.0f * (qw * qx + qy * qz),
                  n2 - 2.0f * (qx * qx + qy * qy));
    pitch = asinf(gpd_clip(2.0f * (qw * qy - qz * qx) / n2, -1.0f, 1.0f));
    yaw = atan2f(2.0f * (qw * qz + qx * qy),
                 n2 - 2.0f * (qy * qy + qz * qz));
}

// Action rows of one drone -> its four rpm.  ONE_D_RPM repeats one action
// over the four motors.
GPD_HD void gpd_action_to_rpm(const GpdStepParams& p, const float* a,
                              float* rpm) {
    const float hover = p.drone.hover_rpm;
    if (p.act_type == GPD_ACT_ONE_D_RPM) {
        const float r = hover * (1.0f + 0.05f * a[0]);
        rpm[0] = r; rpm[1] = r; rpm[2] = r; rpm[3] = r;
    } else {
        for (int k = 0; k < 4; ++k) rpm[k] = hover * (1.0f + 0.05f * a[k]);
    }
}

// Setpoints of the embedded PID from one drone's action rows
// (RLTask._pid_targets): tgt = [pos3 | rpy3 | vel3 | rpy_rates3].  `s` is
// the PRE-step state; `a` holds the RAW action (the history ring stores it
// unscaled).
GPD_HD void gpd_pid_setpoints(const GpdStepParams& p, const float* s,
                              const float* a, float* tgt) {
#pragma unroll
    for (int k = 0; k < GPD_TR; ++k) tgt[k] = 0.0f;
    const float px = s[0], py = s[1], pz = s[2];
    if (p.act_type == GPD_ACT_PID) {
        // waypoint clamp (core.next_waypoint; reference
        // BaseAviary._calculateNextStep :1105-1147)
        float dest[3] = {a[0], a[1], a[2]};
        if (p.relative_actions) {
            dest[0] = px + p.action_scale * a[0];
            dest[1] = py + p.action_scale * a[1];
            dest[2] = pz + p.action_scale * a[2];
        }
        const float dx = dest[0] - px, dy = dest[1] - py, dz = dest[2] - pz;
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        const float safe = dist > 0.0f ? dist : 1.0f;
        const bool within = dist <= p.step_size;
        tgt[0] = within ? dest[0] : px + dx / safe * p.step_size;
        tgt[1] = within ? dest[1] : py + dy / safe * p.step_size;
        tgt[2] = within ? dest[2] : pz + dz / safe * p.step_size;
    } else if (p.act_type == GPD_ACT_VEL) {
        // [vx, vy, vz, speed fraction]: hold position and yaw, fly along the
        // unit direction; a zero vector commands zero velocity
        const float vx = a[0], vy = a[1], vz = a[2];
        const float norm = sqrtf(vx * vx + vy * vy + vz * vz);
        const float inv = norm > 0.0f ? 1.0f / norm : 0.0f;
        const float mag = p.speed_limit * fabsf(a[3]) * inv;
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        tgt[0] = px; tgt[1] = py; tgt[2] = pz;
        tgt[5] = yaw;
        tgt[6] = mag * vx; tgt[7] = mag * vy; tgt[8] = mag * vz;
    } else {  // GPD_ACT_ONE_D_PID: a height offset
        tgt[0] = px; tgt[1] = py; tgt[2] = pz + 0.1f * a[0];
    }
}

// One cascaded DSL-PID tick on one column (reference DSLPIDControl.py:
// position loop :149-208, attitude loop :212-259; gains :37-60).
// s = state (pos, quat, vel used), pid = [last_rpy3 | integral_pos_e3 |
// integral_rpy_e3], tgt = 12 setpoint rows.  Writes the four rpm and the
// nine new PID rows.
GPD_HD void gpd_pid_tick(const GpdPid& c, float ctrl_dt, const float* s,
                         const float* pid, const float* tgt, float* rpm,
                         float* npid) {
    const float P_FOR[3] = {0.4f, 0.4f, 1.25f};
    const float I_FOR[3] = {0.05f, 0.05f, 0.05f};
    const float D_FOR[3] = {0.2f, 0.2f, 0.5f};
    const float P_TOR[3] = {70000.0f, 70000.0f, 60000.0f};
    const float I_TOR[3] = {0.0f, 0.0f, 500.0f};
    const float D_TOR[3] = {20000.0f, 20000.0f, 12000.0f};
    const float PWM2RPM_SCALE = 0.2685f, PWM2RPM_CONST = 4070.3f;
    const float MIN_PWM = 20000.0f, MAX_PWM = 65535.0f;
    const float MIXER_CF2X[4][3] = {{-0.5f, -0.5f, -1.0f},
                                    {-0.5f, 0.5f, 1.0f},
                                    {0.5f, 0.5f, -1.0f},
                                    {0.5f, -0.5f, 1.0f}};
    const float MIXER_CF2P[4][3] = {{0.0f, -1.0f, -1.0f},
                                    {1.0f, 0.0f, 1.0f},
                                    {0.0f, 1.0f, -1.0f},
                                    {-1.0f, 0.0f, 1.0f}};

    const float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
    // current rotation matrix from the (normalization-invariant) quat
    const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
    const float inv_n2 = 1.0f / n2;
    const float xx = qx * qx * inv_n2, yy = qy * qy * inv_n2,
                zz = qz * qz * inv_n2;
    const float xy = qx * qy * inv_n2, xz = qx * qz * inv_n2,
                yz = qy * qz * inv_n2;
    const float wxq = qw * qx * inv_n2, wyq = qw * qy * inv_n2,
                wzq = qw * qz * inv_n2;
    const float c00 = 1.0f - 2.0f * (yy + zz), c01 = 2.0f * (xy - wzq),
                c02 = 2.0f * (xz + wyq);
    const float c10 = 2.0f * (xy + wzq), c11 = 1.0f - 2.0f * (xx + zz),
                c12 = 2.0f * (yz - wxq);
    const float c20 = 2.0f * (xz - wyq), c21 = 2.0f * (yz + wxq),
                c22 = 1.0f - 2.0f * (xx + yy);

    // ---- position loop ----
    float pe[3], ve[3], ip[3], tt[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        pe[i] = tgt[i] - s[i];
        ve[i] = tgt[6 + i] - s[7 + i];
        ip[i] = gpd_clip(pid[3 + i] + pe[i] * ctrl_dt, -2.0f, 2.0f);
    }
    ip[2] = gpd_clip(ip[2], -0.15f, 0.15f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        tt[i] = P_FOR[i] * pe[i] + I_FOR[i] * ip[i] + D_FOR[i] * ve[i];
    tt[2] = tt[2] + c.gravity;
    const float scalar_thrust =
        fmaxf(0.0f, tt[0] * c02 + tt[1] * c12 + tt[2] * c22);
    const float thrust_pwm =
        (sqrtf(scalar_thrust / c.kf4) - PWM2RPM_CONST) / PWM2RPM_SCALE;
    const float tt_norm = sqrtf(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]);
    const float zax[3] = {tt[0] / tt_norm, tt[1] / tt_norm, tt[2] / tt_norm};
    float cyaw, syaw;   // sincosf: as in gpd_dyn_substep
    sincosf(tgt[5], &syaw, &cyaw);
    // y_ax = normalize(z_ax x x_c), x_c = [cos yaw, sin yaw, 0]
    const float zxc[3] = {-zax[2] * syaw, zax[2] * cyaw,
                          zax[0] * syaw - zax[1] * cyaw};
    const float zxc_n =
        sqrtf(zxc[0] * zxc[0] + zxc[1] * zxc[1] + zxc[2] * zxc[2]);
    const float yax[3] = {zxc[0] / zxc_n, zxc[1] / zxc_n, zxc[2] / zxc_n};
    const float xax0 = yax[1] * zax[2] - yax[2] * zax[1];
    // target rotation columns are (x_ax, y_ax, z_ax); intrinsic-XYZ Euler
    // (ops/quat.mat_to_euler_xyz): b = asin(m02), a = atan2(-m12, m22),
    // c = atan2(-m01, m00).  asinf does not clip its argument: after the
    // normalisation zax[0] can be 1 + 1 ulp.
    const float ea = atan2f(-zax[1], zax[2]);
    const float eb = asinf(gpd_clip(zax[0], -1.0f, 1.0f));
    const float ec = atan2f(-yax[0], xax0);

    // ---- attitude loop ----
    float cr, cp, cy;
    gpd_quat_rpy(qx, qy, qz, qw, cr, cp, cy);
    // R(target_euler) = Rx(ea) @ Ry(eb) @ Rz(ec)
    float ca, sa, cb, sb, cc, sc;
    sincosf(ea, &sa, &ca);
    sincosf(eb, &sb, &cb);
    sincosf(ec, &sc, &cc);
    const float t00 = cb * cc, t01 = -cb * sc, t02 = sb;
    const float t10 = ca * sc + sa * sb * cc, t11 = ca * cc - sa * sb * sc,
                t12 = -sa * cb;
    const float t20 = sa * sc - ca * sb * cc, t21 = sa * cc + ca * sb * sc,
                t22 = ca * cb;
    // rot_matrix_e = Rt^T Rc - Rc^T Rt = E - E^T with E = Rt^T Rc
    const float e21 = t02 * c01 + t12 * c11 + t22 * c21;
    const float e12 = t01 * c02 + t11 * c12 + t21 * c22;
    const float e02 = t00 * c02 + t10 * c12 + t20 * c22;
    const float e20 = t02 * c00 + t12 * c10 + t22 * c20;
    const float e10 = t01 * c00 + t11 * c10 + t21 * c20;
    const float e01 = t00 * c01 + t10 * c11 + t20 * c21;
    const float rot_e[3] = {e21 - e12, e02 - e20, e10 - e01};
    const float cur[3] = {cr, cp, cy};
    float rre[3], ir[3], tq[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        rre[i] = tgt[9 + i] - (cur[i] - pid[i]) / ctrl_dt;
        ir[i] = gpd_clip(pid[6 + i] - rot_e[i] * ctrl_dt, -1500.0f, 1500.0f);
    }
    ir[0] = gpd_clip(ir[0], -1.0f, 1.0f);
    ir[1] = gpd_clip(ir[1], -1.0f, 1.0f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        tq[i] = gpd_clip(-P_TOR[i] * rot_e[i] + D_TOR[i] * rre[i]
                             + I_TOR[i] * ir[i],
                         -3200.0f, 3200.0f);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
        const float m0 = c.plus_mixer ? MIXER_CF2P[m][0] : MIXER_CF2X[m][0];
        const float m1 = c.plus_mixer ? MIXER_CF2P[m][1] : MIXER_CF2X[m][1];
        const float m2 = c.plus_mixer ? MIXER_CF2P[m][2] : MIXER_CF2X[m][2];
        float pwm = thrust_pwm + m0 * tq[0] + m1 * tq[1] + m2 * tq[2];
        pwm = gpd_clip(pwm, MIN_PWM, MAX_PWM);
        rpm[m] = PWM2RPM_SCALE * pwm + PWM2RPM_CONST;
    }
    npid[0] = cr; npid[1] = cp; npid[2] = cy;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        npid[3 + i] = ip[i];
        npid[6 + i] = ir[i];
    }
}

// ---- the PYB family: Bullet-like integrator, contact, aero effects ----

// NaN-keeping max / min against a bound, as the plain versions' clamp.
GPD_HD float gpd_at_least(float x, float lo) { return x < lo ? lo : x; }
GPD_HD float gpd_at_most(float x, float hi) { return x > hi ? hi : x; }

GPD_HD void gpd_mv(const float* r, const float* v, float* o) {
    o[0] = r[0] * v[0] + r[1] * v[1] + r[2] * v[2];
    o[1] = r[3] * v[0] + r[4] * v[1] + r[5] * v[2];
    o[2] = r[6] * v[0] + r[7] * v[1] + r[8] * v[2];
}

GPD_HD void gpd_mtv(const float* r, const float* v, float* o) {
    o[0] = r[0] * v[0] + r[3] * v[1] + r[6] * v[2];
    o[1] = r[1] * v[0] + r[4] * v[1] + r[7] * v[2];
    o[2] = r[2] * v[0] + r[5] * v[1] + r[8] * v[2];
}

GPD_HD void gpd_cross(const float* a, const float* b, float* o) {
    o[0] = a[1] * b[2] - a[2] * b[1];
    o[1] = a[2] * b[0] - a[0] * b[2];
    o[2] = a[0] * b[1] - a[1] * b[0];
}

GPD_HD float gpd_dot3(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// World inverse inertia applied to v: R (J^-1 (R^T v)).
GPD_HD void gpd_iinv_w(const float* r, const GpdDrone& c, const float* v,
                       float* o) {
    float b[3];
    gpd_mtv(r, v, b);
    const float jb[3] = {c.inv_jx * b[0], c.inv_jy * b[1], c.inv_jz * b[2]};
    gpd_mv(r, jb, o);
}

// Rotation-matrix rows of the (normalized by 1/|q|^2) quaternion q = xyzw.
GPD_HD void gpd_rot_rows(const float* q, float* r) {
    const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
    const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
    const float inv = 1.0f / n2;
    const float xx = qx * qx * inv, yy = qy * qy * inv, zz = qz * qz * inv;
    const float xy = qx * qy * inv, xz = qx * qz * inv, yz = qy * qz * inv;
    const float wx = qw * qx * inv, wy = qw * qy * inv, wz = qw * qz * inv;
    r[0] = 1.0f - 2.0f * (yy + zz); r[1] = 2.0f * (xy - wz);
    r[2] = 2.0f * (xz + wy);
    r[3] = 2.0f * (xy + wz); r[4] = 1.0f - 2.0f * (xx + zz);
    r[5] = 2.0f * (yz - wx);
    r[6] = 2.0f * (xz - wy); r[7] = 2.0f * (yz + wx);
    r[8] = 1.0f - 2.0f * (xx + yy);
}

// v[i] for a motor index known only at run time, by selects: indexing a
// register array at run time would move it to local memory.
GPD_HD float gpd_pick4(const float* v, int i) {
    return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

GPD_HD float gpd_tau_axis(const GpdTorqueAxis& t, const float* rpm) {
    float out = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k)
        if (k < t.n_pairs)
            out = out + gpd_dsq(gpd_pick4(rpm, t.pair_i[k]),
                                gpd_pick4(rpm, t.pair_j[k])) * t.pair_c[k];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (k < t.n_left) {
            const float r = gpd_pick4(rpm, t.left_i[k]);
            out = out + (r * r) * t.left_c[k];
        }
    return out;
}

// Effective mass of one body along `dir` at lever arm `arm`:
// 1/m + ((I^-1 (arm x dir)) x arm) . dir
GPD_HD float gpd_keff1(const float* r, const GpdDrone& c, const float* arm,
                       const float* dir) {
    float rxd[3], ii[3], x[3];
    gpd_cross(arm, dir, rxd);
    gpd_iinv_w(r, c, rxd, ii);
    gpd_cross(ii, arm, x);
    return gpd_dot3(x, dir);
}

// Unit normal and depth of static obstacle `e` against the bounding sphere
// of radius rc about p.  Inside a box: the face of least penetration, the
// first minimum over x, y, z.
GPD_HD void gpd_obstacle_contact(const GpdPyb& y, int e, const float* p,
                                 float* nrm, float& depth) {
    const float* o = y.obs[e];
    if (y.obs_kind[e] == 0) {
        const float dx = p[0] - o[0], dy = p[1] - o[1], dz = p[2] - o[2];
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        const float inv_d = 1.0f / gpd_at_least(dist, 1e-6f);
        nrm[0] = dx * inv_d; nrm[1] = dy * inv_d; nrm[2] = dz * inv_d;
        depth = o[4] - dist;
        return;
    }
    const float rx = p[0] - o[0], ry = p[1] - o[1], rz = p[2] - o[2];
    const float cx = gpd_clip(rx, -o[3], o[3]);
    const float cy = gpd_clip(ry, -o[4], o[4]);
    const float cz = gpd_clip(rz, -o[5], o[5]);
    const float dx = rx - cx, dy = ry - cy, dz = rz - cz;
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool outside = dist > 1e-6f;
    const float inv_d = 1.0f / gpd_at_least(dist, 1e-6f);
    const float px = o[6] - fabsf(rx), py = o[7] - fabsf(ry),
                pz = o[8] - fabsf(rz);
    const bool isx = (px <= py) & (px <= pz);
    const bool isy = !isx & (py <= pz);
    const bool isz = !isx & !isy;
    const float zero = dist * 0.0f;
    nrm[0] = outside ? dx * inv_d : (isx ? (rx >= 0.0f ? 1.0f : -1.0f) : zero);
    nrm[1] = outside ? dy * inv_d : (isy ? (ry >= 0.0f ? 1.0f : -1.0f) : zero);
    nrm[2] = outside ? dz * inv_d : (isz ? (rz >= 0.0f ? 1.0f : -1.0f) : zero);
    const float pen_in = fminf(fminf(px, py), pz);
    depth = outside ? y.rc - dist : pen_in;
}

// One PYB substep of ONE drone: forces and torques from its pre-substep
// state s = [p3 q4 v3 w3], velocity update, contact solve on the pre-substep
// pose, position and quaternion update.  `dw_total` is the summed downwash
// magnitude on this drone from the PRE-substep positions of the others.
GPD_HD void gpd_pyb_drone_substep(const GpdStepParams& P, float* s,
                                  const float* rpm, const float* drag_rpm,
                                  float dw_total, bool has_dw) {
    const GpdDrone& c = P.drone;
    const GpdPyb& y = P.pyb;
    const float dt = P.dt;
    float r[9];
    gpd_rot_rows(s + 3, r);

    // ---- forces and torques from the PRE-substep state ----
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = rpm[i] * rpm[i] * c.kf;
    const float thrust = f[0] + f[1] + f[2] + f[3];
    const float tau_bz =
        (gpd_dsq(rpm[1], rpm[0]) + gpd_dsq(rpm[3], rpm[2])) * c.km_s;
    const float tau_bx = gpd_tau_axis(y.tau_x, rpm);
    const float tau_by = gpd_tau_axis(y.tau_y, rpm);
    float fx = r[2] * thrust;
    float fy = r[5] * thrust;
    float fz = r[8] * thrust;
    float tx = r[0] * tau_bx + r[1] * tau_by + r[2] * tau_bz;
    float ty = r[3] * tau_bx + r[4] * tau_by + r[5] * tau_bz;
    float tz = r[6] * tau_bx + r[7] * tau_by + r[8] * tau_bz;

    if (y.gnd) {
        // ground effect: per-prop heights via analytic FK, gated on
        // |roll|, |pitch| < pi/2
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        const float half_pi = 1.57079632679489661923f;
        const float gate =
            ((fabsf(roll) < half_pi) & (fabsf(pitch) < half_pi)) ? 1.0f : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float ox = y.prop_x[i], oy = y.prop_y[i];
            const float wox = r[0] * ox + r[1] * oy;
            const float woy = r[3] * ox + r[4] * oy;
            const float woz = r[6] * ox + r[7] * oy;
            const float h = gpd_at_least(s[2] + woz, y.gnd_eff_h_clip);
            const float q = y.prop_radius / (4.0f * h);
            const float g = (f[i] * y.gnd_eff_coeff * (q * q)) * gate;
            const float gx = g * r[2], gy = g * r[5], gz = g * r[8];
            fx = fx + gx; fy = fy + gy; fz = fz + gz;
            // torque: world_off x world-frame prop force
            tx = tx + (woy * gz - woz * gy);
            ty = ty + (woz * gx - wox * gz);
            tz = tz + (wox * gy - woy * gx);
        }
    }
    if (y.drag) {
        // R R^T (-c * sum(omega) * v) with the stale rpm of this substep
        const float omega =
            (drag_rpm[0] + drag_rpm[1] + drag_rpm[2] + drag_rpm[3])
            * y.rpm_to_rad;
        const float pre[3] = {y.neg_drag_c[0] * omega * s[7],
                              y.neg_drag_c[1] * omega * s[8],
                              y.neg_drag_c[2] * omega * s[9]};
        const float bx = r[0] * pre[0] + r[3] * pre[1] + r[6] * pre[2];
        const float by = r[1] * pre[0] + r[4] * pre[1] + r[7] * pre[2];
        const float bz = r[2] * pre[0] + r[5] * pre[1] + r[8] * pre[2];
        fx = fx + r[0] * bx + r[1] * by + r[2] * bz;
        fy = fy + r[3] * bx + r[4] * by + r[5] * bz;
        fz = fz + r[6] * bx + r[7] * by + r[8] * bz;
    }
    if (has_dw) {
        fx = fx - dw_total * r[2];
        fy = fy - dw_total * r[5];
        fz = fz - dw_total * r[8];
    }

    // ---- semi-implicit velocity update, gyroscopic bias, damping ----
    float v[3] = {s[7], s[8], s[9]};
    float w[3] = {s[10], s[11], s[12]};
    v[0] = (v[0] + dt * fx * c.inv_m) * y.lin_damp;
    v[1] = (v[1] + dt * fy * c.inv_m) * y.lin_damp;
    v[2] = (v[2] + dt * (fz * c.inv_m - 9.8f)) * y.lin_damp;
    {
        // dw_b = J^-1 (R^T tau - w_b x (J w_b))
        const float tau[3] = {tx, ty, tz};
        float tb[3], wb[3], gy[3], dw[3];
        gpd_mtv(r, tau, tb);
        gpd_mtv(r, w, wb);
        const float jw[3] = {c.jx * wb[0], c.jy * wb[1], c.jz * wb[2]};
        gpd_cross(wb, jw, gy);
        const float db[3] = {c.inv_jx * (tb[0] - gy[0]),
                             c.inv_jy * (tb[1] - gy[1]),
                             c.inv_jz * (tb[2] - gy[2])};
        gpd_mv(r, db, dw);
        w[0] = (w[0] + dt * dw[0]) * y.ang_damp;
        w[1] = (w[1] + dt * dw[1]) * y.ang_damp;
        w[2] = (w[2] + dt * dw[2]) * y.ang_damp;
    }

    // ---- contact solve on the PRE-substep pose (PGS) ----
    // Each rim contact's constants of the substep (lever arm, active flag,
    // speculative target velocity, effective masses) are a row of a table
    // in the thread's local memory (cached in L1), read one contact ahead
    // of its impulses; in registers they would hold 32 of them through the
    // sweeps.  `volatile` keeps each read inside the sweep where it stands.
    const float nvec[3] = {0.0f, 0.0f, 1.0f};
    const float t1v[3] = {1.0f, 0.0f, 0.0f};
    const float t2v[3] = {0.0f, 1.0f, 0.0f};
    const float rim_x[4] = {y.rc, 0.0f, -y.rc, 0.0f};
    const float rim_y[4] = {0.0f, y.rc, 0.0f, -y.rc};
    volatile float rim[4][8];  // arm3, active, target, kn, kt_x, kt_y
    float acc_n[4], acc_t[2][4];
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) {
        const float body[3] = {rim_x[ki], rim_y[ki], y.z_lo};
        float arm[3];
        gpd_mv(r, body, arm);
        const float pen = -(s[2] + arm[2]);
        rim[ki][3] = pen > -y.slop ? 1.0f : 0.0f;
        // Baumgarte push-out when penetrating, closing limit depth/dt when
        // separated within the slop window
        rim[ki][4] = pen > 0.0f ? y.erp_dt * pen : y.inv_dt * pen;
        rim[ki][5] = c.inv_m + gpd_keff1(r, c, arm, nvec);
        rim[ki][6] = c.inv_m + gpd_keff1(r, c, arm, t1v);
        rim[ki][7] = c.inv_m + gpd_keff1(r, c, arm, t2v);
        rim[ki][0] = arm[0]; rim[ki][1] = arm[1]; rim[ki][2] = arm[2];
        acc_n[ki] = 0.0f; acc_t[0][ki] = 0.0f; acc_t[1][ki] = 0.0f;
    }
    // static obstacles as centred contacts: no lever arm, no angular term.
    // The obstacle loops run over the configured count, rolled, so these
    // arrays are a table indexed at run time in the thread's local memory,
    // touched only where obstacles are configured: in registers they would
    // hold 48 of them through the sweeps at any count.
    float en[GPD_MAX_OBSTACLES][3], edepth[GPD_MAX_OBSTACLES];
    float eacc[GPD_MAX_OBSTACLES], etan[GPD_MAX_OBSTACLES];
#pragma unroll 1
    for (int e = 0; e < y.n_obstacles; ++e) {
        gpd_obstacle_contact(y, e, s, en[e], edepth[e]);
        eacc[e] = 0.0f; etan[e] = 0.0f;
    }
    float cur[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) cur[k] = rim[0][k];
#pragma unroll 1
    for (int it = 0; it < y.sweeps; ++it) {
#pragma unroll
        for (int ki = 0; ki < 4; ++ki) {
            // the next contact's row (after the last, the next sweep's
            // first), in flight during this contact's impulses
            float nxt[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) nxt[k] = rim[(ki + 1) & 3][k];
            const float arm[3] = {cur[0], cur[1], cur[2]};
            const float a = cur[3], tgt = cur[4], kn = cur[5];
            const float kt[2] = {cur[6], cur[7]};
            // normal impulse (accumulated, clamped >= 0)
            float wxr[3], t[3], dwv[3];
            gpd_cross(w, arm, wxr);
            const float vn = v[2] + wxr[2];
            float dj = (tgt - vn) / kn;
            float new_acc = gpd_at_least(acc_n[ki] + dj, 0.0f) * a;
            dj = new_acc - acc_n[ki];
            acc_n[ki] = new_acc;
            v[2] = v[2] + c.inv_m * dj;
            const float imp_n[3] = {0.0f, 0.0f, dj};
            gpd_cross(arm, imp_n, t);
            gpd_iinv_w(r, c, t, dwv);
            w[0] = w[0] + dwv[0]; w[1] = w[1] + dwv[1]; w[2] = w[2] + dwv[2];
            const float lim = y.mu * acc_n[ki];
            // tangential impulses (Coulomb cone on the accumulated normal)
#pragma unroll
            for (int td = 0; td < 2; ++td) {
                gpd_cross(w, arm, wxr);
                const float vt = v[td] + wxr[td];
                dj = -vt / kt[td];
                new_acc = gpd_clip(acc_t[td][ki] + dj, -lim, lim) * a;
                dj = new_acc - acc_t[td][ki];
                acc_t[td][ki] = new_acc;
                v[td] = v[td] + c.inv_m * dj;
                const float imp_t[3] = {td == 0 ? dj : 0.0f,
                                        td == 0 ? 0.0f : dj, 0.0f};
                gpd_cross(arm, imp_t, t);
                gpd_iinv_w(r, c, t, dwv);
                w[0] = w[0] + dwv[0]; w[1] = w[1] + dwv[1];
                w[2] = w[2] + dwv[2];
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) cur[k] = nxt[k];
        }
#pragma unroll 1
        for (int e = 0; e < y.n_obstacles; ++e) {
            const float* n_ = en[e];
            const float depth = edepth[e];
            const float a = depth > -y.slop ? 1.0f : 0.0f;
            const float vn = v[0] * n_[0] + v[1] * n_[1] + v[2] * n_[2];
            const float tgt = depth > 0.0f ? y.erp_dt * depth
                                           : y.inv_dt * depth;
            float dj = (tgt - vn) * y.m;
            const float new_acc = gpd_at_least(eacc[e] + dj, 0.0f) * a;
            dj = new_acc - eacc[e];
            eacc[e] = new_acc;
            v[0] = v[0] + dj * c.inv_m * n_[0];
            v[1] = v[1] + dj * c.inv_m * n_[1];
            v[2] = v[2] + dj * c.inv_m * n_[2];
            // linear Coulomb friction; the ACCUMULATED tangential impulse
            // is clamped to the cone mu * acc_n
            const float vn2 = v[0] * n_[0] + v[1] * n_[1] + v[2] * n_[2];
            const float vtx = v[0] - vn2 * n_[0];
            const float vty = v[1] - vn2 * n_[1];
            const float vtz = v[2] - vn2 * n_[2];
            const float vt_norm = sqrtf(vtx * vtx + vty * vty + vtz * vtz);
            const float j_stop = vt_norm * y.m;
            const float new_t =
                gpd_at_most(etan[e] + j_stop, y.mu * new_acc) * a;
            const float dj_t = gpd_at_least(new_t - etan[e], 0.0f);
            etan[e] = new_t;
            const float lim_v = dj_t * c.inv_m;
            float scale = vt_norm > 1e-9f
                              ? gpd_at_least(vt_norm - lim_v, 0.0f)
                                    / gpd_at_least(vt_norm, 1e-9f)
                              : 1.0f;
            scale = a > 0.0f ? scale : 1.0f;
            v[0] = vtx * scale + (v[0] - vtx);
            v[1] = vty * scale + (v[1] - vty);
            v[2] = vtz * scale + (v[2] - vtz);
        }
    }

    // ---- position update with the corrected velocity ----
    s[0] = s[0] + dt * v[0];
    s[1] = s[1] + dt * v[1];
    s[2] = s[2] + dt * v[2];
    // world-frame exponential-map quaternion update (left Hamilton
    // product), kept as it is when ||w|| <= 1e-8
    const float norm = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
    const float theta = norm * P.half_dt;
    const float cth = cosf(theta);
    const float safe = norm > 0.0f ? norm : 1.0f;
    const float sth = sinf(theta) / safe;
    const float ax = sth * w[0], ay = sth * w[1], az = sth * w[2];
    const float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
    const float nqx = cth * qx + ax * qw + ay * qz - az * qy;
    const float nqy = cth * qy - ax * qz + ay * qw + az * qx;
    const float nqz = cth * qz + ax * qy - ay * qx + az * qw;
    const float nqw = cth * qw - ax * qx - ay * qy - az * qz;
    if (!(norm <= 1e-8f)) {
        s[3] = nqx; s[4] = nqy; s[5] = nqz; s[6] = nqw;
    }
    s[7] = v[0]; s[8] = v[1]; s[9] = v[2];
    s[10] = w[0]; s[11] = w[1]; s[12] = w[2];
}

// World point m clamped into the collision cylinder of the body at p with
// rotation rows r.
GPD_HD void gpd_cyl_clamp(const GpdPyb& y, const float* p, const float* r,
                          const float* m, float* o) {
    const float d[3] = {m[0] - p[0], m[1] - p[1], m[2] - p[2]};
    float u[3], wq[3];
    gpd_mtv(r, d, u);
    const float ur = sqrtf(u[0] * u[0] + u[1] * u[1]);
    const float sc = gpd_at_most(y.rc / gpd_at_least(ur, 1e-9f), 1.0f);
    const float q[3] = {u[0] * sc, u[1] * sc, gpd_clip(u[2], y.z_lo, y.z_hi)};
    gpd_mv(r, q, wq);
    o[0] = p[0] + wq[0]; o[1] = p[1] + wq[1]; o[2] = p[2] + wq[2];
}

// Two-body effective mass along `dir` at the lever arms r_i, r_j.
GPD_HD float gpd_keff2(const GpdStepParams& P, const float* rot_i,
                       const float* rot_j, const float* r_i,
                       const float* r_j, const float* dir) {
    const float t_i = gpd_keff1(rot_i, P.drone, r_i, dir);
    const float t_j = gpd_keff1(rot_j, P.drone, r_j, dir);
    return P.pyb.two_inv_m + t_i + t_j;
}

// Drone-drone cylinder-manifold contact of the pair (i, j), i < j, on the
// post-step poses a = drone i and b = drone j ([p3 q4 v3 w3] each, rotation
// rows rot_i, rot_j): the impulse `imp` on i (-imp on j) and the lever
// arms r_i, r_j.  Both members of a pair call it with the same arguments,
// in this (i, j) orientation, and get the same floats.
GPD_HD void gpd_pair_impulse(const GpdStepParams& P, const float* a,
                             const float* b, const float* rot_i,
                             const float* rot_j, float* imp, float* r_i,
                             float* r_j) {
    const GpdPyb& y = P.pyb;
    const float* pi = a;
    const float* vi = a + 7;
    const float* wi = a + 10;
    const float* pj = b;
    const float* vj = b + 7;
    const float* wj = b + 10;
    const float dx = pi[0] - pj[0], dy = pi[1] - pj[1], dz = pi[2] - pj[2];
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const float depth = y.min_d - dist;
    const float hitm = ((depth > -y.slop) & (dist > 1e-6f)) ? 1.0f : 0.0f;
    const float inv_d = 1.0f / gpd_at_least(dist, 1e-6f);
    const float nv[3] = {dx * inv_d, dy * inv_d, dz * inv_d};
    const float mid[3] = {0.5f * (pi[0] + pj[0]), 0.5f * (pi[1] + pj[1]),
                          0.5f * (pi[2] + pj[2])};
    float si[3], sj[3];
    gpd_cyl_clamp(y, pi, rot_i, mid, si);
    gpd_cyl_clamp(y, pj, rot_j, mid, sj);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r_i[k] = 0.5f * (si[k] + sj[k]) - pi[k];
        r_j[k] = 0.5f * (si[k] + sj[k]) - pj[k];
    }
    float wxr_i[3], wxr_j[3];
    gpd_cross(wi, r_i, wxr_i);
    gpd_cross(wj, r_j, wxr_j);
    const float rel[3] = {vi[0] + wxr_i[0] - vj[0] - wxr_j[0],
                          vi[1] + wxr_i[1] - vj[1] - wxr_j[1],
                          vi[2] + wxr_i[2] - vj[2] - wxr_j[2]};
    const float vn = gpd_dot3(rel, nv);
    const float tgt = depth > 0.0f ? y.erp_dt * depth : y.inv_dt * depth;
    const float j_n = gpd_at_least(tgt - vn, 0.0f)
                      / gpd_keff2(P, rot_i, rot_j, r_i, r_j, nv) * hitm;
    const float vtv[3] = {rel[0] - vn * nv[0], rel[1] - vn * nv[1],
                          rel[2] - vn * nv[2]};
    const float vt_n = sqrtf(gpd_dot3(vtv, vtv));
    const float inv_vt = 1.0f / gpd_at_least(vt_n, 1e-9f);
    const float tv[3] = {vtv[0] * inv_vt, vtv[1] * inv_vt, vtv[2] * inv_vt};
    const float j_t =
        gpd_at_most(vt_n / gpd_keff2(P, rot_i, rot_j, r_i, r_j, tv),
                    y.mu * j_n) * hitm;
#pragma unroll
    for (int k = 0; k < 3; ++k) imp[k] = j_n * nv[k] - j_t * tv[k];
}

// Downwash magnitude on the drone at `own` from the drone at `src`, both
// PRE-substep positions: zero unless src is above and within 10 m.
GPD_HD float gpd_downwash_term(const GpdPyb& y, const float* src,
                               const float* own) {
    const float dz = src[2] - own[2];
    const float dx = src[0] - own[0];
    const float dy = src[1] - own[1];
    const float dxy = sqrtf(dx * dx + dy * dy);
    const bool mask = (dz > 0.0f) & (dxy < 10.0f);
    const float safe_dz = mask ? dz : 1.0f;
    const float q = y.prop_radius / (4.0f * safe_dz);
    const float alpha = y.dw1 * (q * q);
    const float beta = y.dw2 * safe_dz + y.dw3;
    const float u = dxy / beta;
    const float mag = alpha * expf(-0.5f * (u * u));
    return mask ? mag : 0.0f;
}

// n_substeps coupled PYB substeps of ONE drone, the counterpart of the TPU
// kernels' `_pyb_substep_all`, run by every thread of a block whose warp w
// holds drone w of GPD_ENVS envs; this thread is drone d of env `lane`.
// s = [p3 q4 v3 w3] stays in registers and is updated in place; rpm is the
// applied rpm, `last` the previous control step's (the stale drag of
// substep 0, read only when `drag`).  `sh` holds two pose buffers of
// n x GPD_PS x GPD_ENVS floats, used in turn: substep i writes its
// post-step poses to buffer i % 2, while the downwash of substep i reads
// the PRE-substep positions from the other (the drone-drone contact
// changes velocities only, so a post-step position is the next substep's
// pre-substep one).  One barrier per substep, plus one ahead of the first
// downwash.  Every thread of the block calls this, those past the last env
// too: it meets the others at barriers.
//
// Per substep: (i) the downwash on this drone from the others in ascending
// index; (ii) gpd_pyb_drone_substep on its own state; (iii) its post-step
// pose to shared memory, barrier; (iv) the drone-drone contact: every pair
// this drone belongs to, in ascending partner order, each evaluated in its
// (min, max) orientation, this drone's share summed in the order of the
// one-thread-per-env loop over pairs, and applied once all are done.
__device__ __forceinline__ void gpd_pyb_ctrl_substeps(
    const GpdStepParams& P, float* s, const float* rpm, const float* last,
    bool drag, float* sh, int d, int lane) {
    const GpdPyb& y = P.pyb;
    const int n = P.n_drones;
    const bool has_dw = y.dw && n > 1;
    const int buf = n * GPD_PS * GPD_ENVS;
#define GPD_POSE(base, j, r) (base)[((j) * GPD_PS + (r)) * GPD_ENVS + lane]
    if (has_dw) {
#pragma unroll
        for (int k = 0; k < 3; ++k) GPD_POSE(sh + buf, d, k) = s[k];
        GPD_SYNC();
    }
#pragma unroll 1
    for (int i = 0; i < P.n_substeps; ++i) {
        float* cur = sh + (i & 1) * buf;
        const float* prev = sh + ((i + 1) & 1) * buf;
        float dw_total = 0.0f;
        if (has_dw) {
#pragma unroll 1
            for (int j = 0; j < n; ++j) {
                if (j == d) continue;
                const float src[3] = {GPD_POSE(prev, j, 0),
                                      GPD_POSE(prev, j, 1),
                                      GPD_POSE(prev, j, 2)};
                dw_total = dw_total + gpd_downwash_term(y, src, s);
            }
        }
        float drag_rpm[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
            drag_rpm[k] = (drag && i == 0) ? last[k] : rpm[k];
        gpd_pyb_drone_substep(P, s, rpm, drag_rpm, dw_total, has_dw);
        if (n == 1) continue;
#pragma unroll
        for (int k = 0; k < GPD_PS; ++k) GPD_POSE(cur, d, k) = s[k];
        GPD_SYNC();
        // the pose buffer holds this drone's post-step pose bit for bit, so
        // the pair loop reads each pair's poses from it by index and keeps
        // nothing of s in registers; s comes back from it afterwards
        float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
            if (j == d) continue;
            // one call site for both orientations: the pair's first member
            // is the lower index
            const bool first = d < j;
            const int lo = first ? d : j, hi = first ? j : d;
            float a[GPD_PS], b[GPD_PS], ra[9], rb[9];
#pragma unroll
            for (int k = 0; k < GPD_PS; ++k) {
                a[k] = GPD_POSE(cur, lo, k);
                b[k] = GPD_POSE(cur, hi, k);
            }
            gpd_rot_rows(a + 3, ra);
            gpd_rot_rows(b + 3, rb);
            float imp[3], r_i[3], r_j[3];
            gpd_pair_impulse(P, a, b, ra, rb, imp, r_i, r_j);
            float arm[3], own_imp[3], rot_own[9], t[3], dw[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                arm[k] = first ? r_i[k] : r_j[k];
                own_imp[k] = first ? imp[k] : -imp[k];
            }
#pragma unroll
            for (int k = 0; k < 9; ++k) rot_own[k] = first ? ra[k] : rb[k];
            gpd_cross(arm, own_imp, t);
            gpd_iinv_w(rot_own, P.drone, t, dw);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                acc[k] = acc[k] + own_imp[k];
                acc[3 + k] = acc[3 + k] + dw[k];
            }
        }
#pragma unroll
        for (int k = 0; k < GPD_PS; ++k) s[k] = GPD_POSE(cur, d, k);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            s[7 + k] = s[7 + k] + P.drone.inv_m * acc[k];
            s[10 + k] = s[10 + k] + acc[3 + k];
        }
    }
#undef GPD_POSE
}

// Running sums of a task's row_post over the drones of one env.
struct GpdPostAcc {
    float reward;    // summed reward
    float dist_sum;  // MultiHover: summed distance to the targets
    float d2;        // Hover: squared distance of drone 0
    bool out_any;    // any scoring drone outside the box or tilted
    bool all_in;     // Routing: every drone within arrival_tol so far
};

// One drone's share of its task's row_post, taken by the drone's own thread
// and summed over the drones of the env, in drone order, by gpd_post_add.
struct GpdPostShare {
    float r;         // reward
    float x;         // Hover: squared distance; MultiHover: distance
    bool out;        // outside the box or tilted (Routing: tilted)
    bool in;         // Routing: within arrival_tol
};

GPD_HD void gpd_post_init(GpdPostAcc& acc) {
    acc.reward = 0.0f; acc.dist_sum = 0.0f; acc.d2 = 0.0f;
    acc.out_any = false; acc.all_in = true;
}

// One drone's share of reward / distance / out-of-bounds against target d.
GPD_HD void gpd_post_drone(const GpdStepParams& p, int d, float px, float py,
                           float pz, float roll, float pitch, float& r,
                           float& d2, bool& out) {
    const float dx = p.target[d][0] - px, dy = p.target[d][1] - py,
                dz = p.target[d][2] - pz;
    d2 = dx * dx + dy * dy + dz * dz;
    r = fmaxf(0.0f, 2.0f - d2 * d2);   // ||d||^4 == (||d||^2)^2
    out = (fabsf(px) > p.box_xy) | (fabsf(py) > p.box_xy) | (pz > p.box_z) |
          (fabsf(roll) > p.tilt) | (fabsf(pitch) > p.tilt);
}

// RoutingTask.row_post, one drone's share (envs/routing.py): progress
// toward the destination gated off inside arrival_tol plus a hold bonus
// (shaped), or -distance + 10 on arrival; all-arrived termination; any
// drone tilted truncates.  `v` is the stepped velocity.
GPD_HD void gpd_routing_row_post(const GpdStepParams& p, int d, float px,
                                 float py, float pz, float vx, float vy,
                                 float vz, float roll, float pitch,
                                 GpdPostShare& sh) {
    const float dx = p.target[d][0] - px, dy = p.target[d][1] - py,
                dz = p.target[d][2] - pz;
    const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
    const bool arrived = dist < p.arrival_tol;
    const float af = arrived ? 1.0f : 0.0f;
    if (p.shaped) {
        const float inv = 1.0f / fmaxf(dist, p.arrival_tol);
        const float prog = (vx * dx + vy * dy + vz * dz) * inv * p.ctrl_dt;
        const float hold = expf(-dist / p.arrival_tol);
        sh.r = p.progress_gain * prog * (1.0f - af) + p.arrival_hold * hold;
    } else {
        sh.r = -dist + 10.0f * af;
    }
    sh.x = 0.0f;
    sh.in = arrived;
    sh.out = (fabsf(roll) > p.tilt) | (fabsf(pitch) > p.tilt);
}

// Drone d's share of its task's row_post from its STEPPED state:
// s = [p3 q4 v3 ...].  Hover (reference envs/HoverAviary.py) and MultiHover
// (envs/MultiHoverAviary.py) score the distance to target d; Routing as
// above.
GPD_HD void gpd_post_share(const GpdStepParams& p, int d, const float* s,
                           GpdPostShare& sh) {
    float roll, pitch, yaw;
    gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
    if (p.task_id == GPD_TASK_ROUTING) {
        gpd_routing_row_post(p, d, s[0], s[1], s[2], s[7], s[8], s[9], roll,
                             pitch, sh);
        return;
    }
    float d2;
    gpd_post_drone(p, d, s[0], s[1], s[2], roll, pitch, sh.r, d2, sh.out);
    sh.x = p.task_id == GPD_TASK_HOVER ? d2 : sqrtf(d2);
    sh.in = false;
}

// Adds drone d's share; called for d = 0, 1, ... in order.  Hover: drone 0
// scores alone.  MultiHover: summed reward and distance, any-drone
// truncation.  Routing: summed reward, all-arrived, any-drone tilt.
GPD_HD void gpd_post_add(const GpdStepParams& p, int d,
                         const GpdPostShare& sh, GpdPostAcc& acc) {
    if (p.task_id == GPD_TASK_HOVER) {
        if (d != 0) return;
        acc.reward = sh.r; acc.d2 = sh.x; acc.out_any = sh.out;
        return;
    }
    acc.reward = d == 0 ? sh.r : acc.reward + sh.r;
    acc.dist_sum = d == 0 ? sh.x : acc.dist_sum + sh.x;
    acc.out_any = acc.out_any | sh.out;
    acc.all_in = acc.all_in & sh.in;
}

// Position of drone j of one env from an (n, 3, GPD_ENVS) block of
// positions, `pos` pointing at the env's entry of drone 0's first row.
GPD_HD void gpd_env_pos(const float* pos, int j, float* out) {
    const float* q = pos + j * 3 * GPD_ENVS;
    out[0] = q[0]; out[1] = q[GPD_ENVS]; out[2] = q[2 * GPD_ENVS];
}

// RoutingTask.row_post, the separation penalty over the STEPPED positions
// `pos` of the env's drones: 10 per unordered pair closer than the
// collision radius (twice 5: the tensor code counts both orders).
GPD_HD void gpd_routing_pairs(const GpdStepParams& p, const float* pos,
                              GpdPostAcc& acc) {
    for (int i = 0; i < p.n_drones; ++i) {
        float pi[3];
        gpd_env_pos(pos, i, pi);
        for (int j = i + 1; j < p.n_drones; ++j) {
            float pj[3];
            gpd_env_pos(pos, j, pj);
            const float dx = pi[0] - pj[0], dy = pi[1] - pj[1],
                        dz = pi[2] - pj[2];
            const float d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < p.collision_r2) acc.reward = acc.reward - 10.0f;
        }
    }
}

// RoutingTask.row_extra_obs of drone i from the SELECTED (post-reset)
// positions `pos`: goal vector, then the displacement pos_j - pos_i to the
// nearest neighbour on the squared distance.  Strict < over ascending j:
// the lowest index wins a tie (the drones spawn on a line at equal
// spacing).  A lone drone gets zeros.
GPD_HD void gpd_routing_extra_obs(const GpdStepParams& p, const float* pos,
                                  int i, float* e) {
    float pi[3];
    gpd_env_pos(pos, i, pi);
    e[0] = p.target[i][0] - pi[0];
    e[1] = p.target[i][1] - pi[1];
    e[2] = p.target[i][2] - pi[2];
    // zeros, written as the plain rows write them (a NaN stays a NaN)
    e[3] = pi[0] * 0.0f; e[4] = e[3]; e[5] = e[3];
    float best_d2 = 0.0f;
    bool have = false;
    for (int j = 0; j < p.n_drones; ++j) {
        if (j == i) continue;
        float pj[3];
        gpd_env_pos(pos, j, pj);
        const float dx = pj[0] - pi[0], dy = pj[1] - pi[1],
                    dz = pj[2] - pi[2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        if (!have || d2 < best_d2) {
            e[3] = dx; e[4] = dy; e[5] = dz;
            best_d2 = d2;
            have = true;
        }
    }
}

// Flags of the env from the accumulated sums and the PRE-increment substep
// counter.  The timeout is a true division: 1920 / 240 is exactly 8.
GPD_HD void gpd_post_finish(const GpdStepParams& p, const GpdPostAcc& acc,
                            float sc, bool& term, bool& trunc) {
    term = p.task_id == GPD_TASK_HOVER        ? acc.d2 < 1e-8f
           : p.task_id == GPD_TASK_MULTIHOVER ? acc.dist_sum < 1e-4f
                                              : acc.all_in;
    const bool timeout = (sc / p.pyb_freq) > p.episode_len_sec;
    trunc = acc.out_any | timeout;
}
