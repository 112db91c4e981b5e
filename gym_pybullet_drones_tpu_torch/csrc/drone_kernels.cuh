// Shared device functions and the parameter struct of the drone kernels.
//
// The per-column arithmetic lives here once: the motor mixer, the explicit
// DYN substeps, the Euler extraction and the Hover / MultiHover task
// post-processing.  dyn_ctrl_step.cu and fused_env_step.cu are thin
// __global__ shells around these functions, and the PID and PYB kernels
// still to come reuse them.  Everything is float32 and written as
// GPD_HD functions (plain `inline` without nvcc), so the same bodies can
// be compiled for the host.
//
// Formulas mirror the plain PyTorch versions in ops/kernel_dyn.py,
// ops/kernel_math.py and envs/tasks.py line by line; change them together.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GPD_HD __host__ __device__ __forceinline__
#else
#define GPD_HD inline
#endif

#define GPD_MAX_DRONES 8
#define GPD_S 16   // state rows per drone
#define GPD_LR 4   // last-rpm rows per drone

enum { GPD_ACT_RPM = 0, GPD_ACT_ONE_D_RPM = 1 };
enum { GPD_TASK_HOVER = 0, GPD_TASK_MULTIHOVER = 1 };

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

// Everything the TPU kernels folded into their program at trace time.
// Mirrored field by field by `StepParams` in _build.py.
struct GpdStepParams {
    GpdDrone drone;
    int n_drones, n_substeps, act_dim, buf_rows, act_type, task_id;
    float dt, half_dt;        // physics step, and dt/2 rounded from double
    float pyb_freq, episode_len_sec;
    float box_xy, box_z, tilt;
    float init16[GPD_MAX_DRONES][GPD_S];  // per-drone reset state
    float target[GPD_MAX_DRONES][3];      // per-drone task target
};

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

// n explicit-dynamics substeps on one column, state in registers.
// s = [px py pz | qx qy qz qw | vx vy vz | wx wy wz | avx avy avz]; the
// last three are outputs only (stored world angular velocity).
// Semantics: reference BaseAviary.py:815-889.
GPD_HD void gpd_dyn_substeps(const GpdDrone& c, int n_substeps, float dt,
                             float half_dt, float* s, float thrust, float xt,
                             float yt, float zt) {
    float px = s[0], py = s[1], pz = s[2];
    float qx = s[3], qy = s[4], qz = s[5], qw = s[6];
    float vx = s[7], vy = s[8], vz = s[9];
    float wx = s[10], wy = s[11], wz = s[12];
    float avx = s[13], avy = s[14], avz = s[15];
    for (int i = 0; i < n_substeps; ++i) {
        // rotation matrix from the (normalized) quaternion
        const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
        const float inv_n2 = 1.0f / n2;
        const float xx = qx * qx * inv_n2, yy = qy * qy * inv_n2,
                    zz = qz * qz * inv_n2;
        const float xy = qx * qy * inv_n2, xz = qx * qz * inv_n2,
                    yz = qy * qz * inv_n2;
        const float wxq = qw * qx * inv_n2, wyq = qw * qy * inv_n2,
                    wzq = qw * qz * inv_n2;
        const float r00 = 1.0f - 2.0f * (yy + zz), r01 = 2.0f * (xy - wzq),
                    r02 = 2.0f * (xz + wyq);
        const float r10 = 2.0f * (xy + wzq), r11 = 1.0f - 2.0f * (xx + zz),
                    r12 = 2.0f * (yz - wxq);
        const float r20 = 2.0f * (xz - wyq), r21 = 2.0f * (yz + wxq),
                    r22 = 1.0f - 2.0f * (xx + yy);

        const float fx = r02 * thrust;
        const float fy = r12 * thrust;
        const float fz = r22 * thrust - c.gm;
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
        // quaternion is kept as it is when ||w|| <= 1e-8
        const float norm = sqrtf(wx * wx + wy * wy + wz * wz);
        const float theta = norm * half_dt;
        const float cth = cosf(theta);
        const float safe = norm > 0.0f ? norm : 1.0f;
        const float sth = sinf(theta) / safe;
        const float nqx = cth * qx + sth * (wz * qy - wy * qz + wx * qw);
        const float nqy = cth * qy + sth * (-wz * qx + wx * qz + wy * qw);
        const float nqz = cth * qz + sth * (wy * qx - wx * qy + wz * qw);
        const float nqw = cth * qw + sth * (-wx * qx - wy * qy - wz * qz);
        if (!(norm <= 1e-8f)) {
            qx = nqx; qy = nqy; qz = nqz; qw = nqw;
        }

        // stored world angular velocity: PRE-step rotation, post-step rates
        avx = r00 * wx + r01 * wy + r02 * wz;
        avy = r10 * wx + r11 * wy + r12 * wz;
        avz = r20 * wx + r21 * wy + r22 * wz;
    }
    s[0] = px; s[1] = py; s[2] = pz;
    s[3] = qx; s[4] = qy; s[5] = qz; s[6] = qw;
    s[7] = vx; s[8] = vy; s[9] = vz;
    s[10] = wx; s[11] = wy; s[12] = wz;
    s[13] = avx; s[14] = avy; s[15] = avz;
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
    float sp = 2.0f * (qw * qy - qz * qx) / n2;
    sp = sp < -1.0f ? -1.0f : (sp > 1.0f ? 1.0f : sp);
    pitch = asinf(sp);
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

// Running sums of a task's row_post over the drones of one env.
struct GpdPostAcc {
    float reward;    // summed reward
    float dist_sum;  // MultiHover: summed distance to the targets
    float d2;        // Hover: squared distance of drone 0
    bool out_any;    // any scoring drone outside the box or tilted
};

GPD_HD void gpd_post_init(GpdPostAcc& acc) {
    acc.reward = 0.0f; acc.dist_sum = 0.0f; acc.d2 = 0.0f;
    acc.out_any = false;
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

// HoverTask.row_post: drone 0 scores (reference envs/HoverAviary.py).
GPD_HD void gpd_hover_row_post(const GpdStepParams& p, int d, float px,
                               float py, float pz, float roll, float pitch,
                               GpdPostAcc& acc) {
    if (d != 0) return;
    float r, d2; bool out;
    gpd_post_drone(p, 0, px, py, pz, roll, pitch, r, d2, out);
    acc.reward = r; acc.d2 = d2; acc.out_any = out;
}

// MultiHoverTask.row_post: summed reward, summed distance, any-drone
// truncation (reference envs/MultiHoverAviary.py).
GPD_HD void gpd_multihover_row_post(const GpdStepParams& p, int d, float px,
                                    float py, float pz, float roll,
                                    float pitch, GpdPostAcc& acc) {
    float r, d2; bool out;
    gpd_post_drone(p, d, px, py, pz, roll, pitch, r, d2, out);
    const float dd = sqrtf(d2);
    acc.reward = d == 0 ? r : acc.reward + r;
    acc.dist_sum = d == 0 ? dd : acc.dist_sum + dd;
    acc.out_any = acc.out_any | out;
}

// Flags of the env from the accumulated sums and the PRE-increment substep
// counter.  The timeout is a true division: 1920 / 240 is exactly 8.
GPD_HD void gpd_post_finish(const GpdStepParams& p, const GpdPostAcc& acc,
                            float sc, bool& term, bool& trunc) {
    term = p.task_id == GPD_TASK_HOVER ? acc.d2 < 1e-8f
                                       : acc.dist_sum < 1e-4f;
    const bool timeout = (sc / p.pyb_freq) > p.episode_len_sec;
    trunc = acc.out_any | timeout;
}
