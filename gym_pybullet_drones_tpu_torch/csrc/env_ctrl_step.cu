// env_ctrl_step: one control step of every drone of an env, all physics
// modes, per launch: an optional cascaded DSL-PID tick per drone, then
// n_substeps coupled PYB-family substeps over the drones of the env (or the
// explicit DYN substeps per drone), optional obs12.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_env.py:
// env_ctrl_step.  The PYB-family modes couple the drones of an env
// (downwash, drone-drone contact), so one THREAD owns one env and loops
// over its drones.  Blocks are column-per-(env x drone), drone d of env e
// in column e*N + d: a thread reads its N columns with a stride of N floats
// (the lines a warp touches are all used by that warp, for its other
// drones), and the wrapper's outputs stay transposed views of these blocks.
//
//   state (16, B*N): pos3 quat4 vel3 rpy_rates3 ang_v3
//   act   (4, B*N) rpm, or (12, B*N) PID setpoints when pid_in is given
//   pid   (9, B*N), last_rpm (4, B*N): NULL when unused
//   -> state' (16, B*N), rpm (4, B*N) [, pid' (9, B*N)] [, obs12 (12, B*N)]
//
// All drones' live state (13 floats each), their rpm and the stale rpm of
// the drag model sit in per-thread local arrays indexed at run time: local
// memory through L1, interleaved across the threads of a warp.  The loops
// over substeps and drones stay rolled.  rpy_rates (rows 10-12) pass
// through the PYB step; the world ang_v rows 13-15 are carried state there.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

__global__ void env_ctrl_step_kernel(const float* __restrict__ state,
                                     const float* __restrict__ act,
                                     const float* __restrict__ pid_in,
                                     const float* __restrict__ last_rpm,
                                     float* __restrict__ out,
                                     float* __restrict__ rpm_out,
                                     float* __restrict__ pid_out,
                                     float* __restrict__ obs12, int B, int ld,
                                     const __grid_constant__ GpdStepParams p) {
    const int env = blockIdx.x * blockDim.x + threadIdx.x;
    if (env >= B) return;

    const int n = p.n_drones;
    const bool use_pid = pid_in != nullptr;
    const bool pyb = p.pyb.enabled != 0;
    const bool drag = pyb && p.pyb.drag != 0;
    float st[GPD_MAX_DRONES][GPD_PS];
    float rpm[GPD_MAX_DRONES][4], last[GPD_MAX_DRONES][4];
#define AT(ptr, row) (ptr)[(size_t)(row) * ld + col]

#pragma unroll 1
    for (int d = 0; d < n; ++d) {
        const int col = env * n + d;
        float s[GPD_S];
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) s[k] = AT(state, k);
        // ---- controller tick (optional) ----
        if (use_pid) {
            float pid[GPD_PR], tgt[GPD_TR], npid[GPD_PR];
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k) pid[k] = AT(pid_in, k);
#pragma unroll
            for (int k = 0; k < GPD_TR; ++k) tgt[k] = AT(act, k);
            gpd_pid_tick(p.pid, p.ctrl_dt, s, pid, tgt, rpm[d], npid);
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k) AT(pid_out, k) = npid[k];
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) rpm[d][k] = AT(act, k);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) AT(rpm_out, k) = rpm[d][k];

        if (!pyb) {
            // explicit DYN physics: drones are independent
            float thrust, xt, yt, zt;
            gpd_motor_mix(p.drone, rpm[d][0], rpm[d][1], rpm[d][2], rpm[d][3],
                          thrust, xt, yt, zt);
            s[13] = s[14] = s[15] = 0.0f;
            gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s,
                             thrust, xt, yt, zt);
#pragma unroll
            for (int k = 0; k < GPD_S; ++k) AT(out, k) = s[k];
            if (obs12 != nullptr) {
                float roll, pitch, yaw;
                gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
                const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                                     s[7], s[8], s[9], s[13], s[14], s[15]};
#pragma unroll
                for (int k = 0; k < 12; ++k) AT(obs12, k) = o[k];
            }
            continue;
        }
#pragma unroll
        for (int k = 0; k < 10; ++k) st[d][k] = s[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            st[d][10 + k] = s[13 + k];
            AT(out, 10 + k) = s[10 + k];       // rpy_rates pass through
        }
        if (drag) {
#pragma unroll
            for (int k = 0; k < 4; ++k) last[d][k] = AT(last_rpm, k);
        }
    }
    if (!pyb) return;

    // ---- coupled PYB substeps; the drag of substep 0 uses the previous
    // control step's rpm, later substeps the new one ----
#pragma unroll 1
    for (int i = 0; i < p.n_substeps; ++i)
        gpd_pyb_substep_all(p, st, rpm, (drag && i == 0) ? last : rpm);

#pragma unroll 1
    for (int d = 0; d < n; ++d) {
        const int col = env * n + d;
        const float* s = st[d];
#pragma unroll
        for (int k = 0; k < 10; ++k) AT(out, k) = s[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) AT(out, 13 + k) = s[10 + k];
        if (obs12 != nullptr) {
            float roll, pitch, yaw;
            gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
            const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                                 s[7], s[8], s[9], s[10], s[11], s[12]};
#pragma unroll
            for (int k = 0; k < 12; ++k) AT(obs12, k) = o[k];
        }
    }
#undef AT
}

extern "C" int gpd_params_size() { return (int)sizeof(GpdStepParams); }

// Launches on `stream`, does not synchronise, allocates nothing.  B counts
// ENVS; every block holds B * n_drones columns at the row stride `ld`
// (elements between rows).  `pid_in`/`pid_out` (both or neither),
// `last_rpm` and `obs12` may be NULL.  Returns cudaGetLastError().
extern "C" int gpd_env_ctrl_step(const float* state, const float* act,
                                 const float* pid_in, const float* last_rpm,
                                 float* out, float* rpm_out, float* pid_out,
                                 float* obs12, int B, int ld,
                                 const GpdStepParams* p, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    env_ctrl_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        state, act, pid_in, last_rpm, out, rpm_out, pid_out, obs12, B, ld,
        *p);
    return (int)cudaGetLastError();
}
