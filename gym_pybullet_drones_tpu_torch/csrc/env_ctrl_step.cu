// env_ctrl_step: one control step of every drone of an env, all physics
// modes, per launch: an optional cascaded DSL-PID tick per drone, then
// n_substeps coupled PYB-family substeps over the drones of the env (or the
// explicit DYN substeps per drone), optional obs12.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_env.py:
// env_ctrl_step.  Blocks are column-per-(env x drone), drone d of env e in
// column e*N + d:
//
//   state (16, B*N): pos3 quat4 vel3 rpy_rates3 ang_v3
//   act   (4, B*N) rpm, or (12, B*N) PID setpoints when pid_in is given
//   pid   (9, B*N), last_rpm (4, B*N): NULL when unused
//   -> state' (16, B*N), rpm (4, B*N) [, pid' (9, B*N)] [, obs12 (12, B*N)]
//
// One thread per (env, drone).  A block holds GPD_ENVS = 32 envs of N
// drones, 32 * N threads, warp w being drone w of the block's envs: a warp
// reads its columns at a stride of N floats, and the block's other warps
// use the rest of each line through L1.  The grid is ceil(B / 32) blocks,
// fixed by the launcher from B and N.  What bounds the PYB-family modes is
// the dependent chain of one thread (operations, not bytes): each thread
// steps one drone with its state in registers, and the drones of an env
// couple (downwash, drone-drone contact) through shared memory in
// gpd_pyb_ctrl_substeps.  rpy_rates (rows 10-12) pass through the PYB step;
// the world ang_v rows 13-15 are carried state there.  Under DYN the
// drones are independent and no thread waits for another.  Threads past
// the last env go through every barrier and load and store nothing.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

__global__ void __launch_bounds__(GPD_ENVS * GPD_MAX_DRONES)
env_ctrl_step_kernel(const float* __restrict__ state,
                     const float* __restrict__ act,
                     const float* __restrict__ pid_in,
                     const float* __restrict__ last_rpm,
                     float* __restrict__ out, float* __restrict__ rpm_out,
                     float* __restrict__ pid_out,
                     float* __restrict__ obs12, int B, int ld,
                     const __grid_constant__ GpdStepParams p) {
    extern __shared__ float gpd_sh[];
    const int n = p.n_drones;
    const int d = threadIdx.x / GPD_ENVS, lane = threadIdx.x % GPD_ENVS;
    const int env = blockIdx.x * GPD_ENVS + lane;
    const bool valid = env < B;
    const int col = env * n + d;
    const bool use_pid = pid_in != nullptr;
    const bool pyb = p.pyb.enabled != 0;
    const bool drag = pyb && p.pyb.drag != 0;
#define AT(ptr, row) (ptr)[(size_t)(row) * ld + col]

    // every load first, so that they are in flight together; a thread
    // past the last env steps a drone at rest at the origin
    float s[GPD_S], a[GPD_TR], pid[GPD_PR], rpm[4];
    float last[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < GPD_S; ++k) s[k] = k == 6 ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < GPD_TR; ++k) a[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < GPD_PR; ++k) pid[k] = 0.0f;
    if (valid) {
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) s[k] = AT(state, k);
#pragma unroll
        for (int k = 0; k < GPD_TR; ++k)
            if (k < 4 || use_pid) a[k] = AT(act, k);
        if (use_pid) {
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k) pid[k] = AT(pid_in, k);
        }
        if (drag) {
#pragma unroll
            for (int k = 0; k < 4; ++k) last[k] = AT(last_rpm, k);
        }
    }
    // ---- controller tick (optional) ----
    if (use_pid) {
        float npid[GPD_PR];
        gpd_pid_tick(p.pid, p.ctrl_dt, s, pid, a, rpm, npid);
        if (valid) {
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k) AT(pid_out, k) = npid[k];
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) rpm[k] = a[k];
    }
    if (valid) {
#pragma unroll
        for (int k = 0; k < 4; ++k) AT(rpm_out, k) = rpm[k];
    }

    if (!pyb) {
        // explicit DYN physics: drones are independent, no barrier follows
        if (!valid) return;
        float thrust, xt, yt, zt;
        gpd_motor_mix(p.drone, rpm[0], rpm[1], rpm[2], rpm[3], thrust, xt,
                      yt, zt);
        s[13] = s[14] = s[15] = 0.0f;
        gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust,
                         xt, yt, zt);
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
        return;
    }

    // ---- coupled PYB substeps; the drag of substep 0 uses the previous
    // control step's rpm, later substeps the new one ----
    float st[GPD_PS];
#pragma unroll
    for (int k = 0; k < 10; ++k) st[k] = s[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) st[10 + k] = s[13 + k];
    gpd_pyb_ctrl_substeps(p, st, rpm, last, drag, gpd_sh, d, lane);
    if (!valid) return;
#pragma unroll
    for (int k = 0; k < 10; ++k) AT(out, k) = st[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        AT(out, 10 + k) = s[10 + k];       // rpy_rates pass through
        AT(out, 13 + k) = st[10 + k];
    }
    if (obs12 != nullptr) {
        float roll, pitch, yaw;
        gpd_quat_rpy(st[3], st[4], st[5], st[6], roll, pitch, yaw);
        const float o[12] = {st[0], st[1], st[2], roll,   pitch,  yaw,
                             st[7], st[8], st[9], st[10], st[11], st[12]};
#pragma unroll
        for (int k = 0; k < 12; ++k) AT(obs12, k) = o[k];
    }
#undef AT
}

extern "C" int gpd_params_size() { return (int)sizeof(GpdStepParams); }

// Blocks and threads per block of the launch gpd_env_ctrl_step makes over
// B envs of n drones: GPD_ENVS envs a block, one thread per (env, drone).
extern "C" void gpd_env_ctrl_step_geometry(int B, int n, int* blocks,
                                           int* threads) {
    *blocks = (B + GPD_ENVS - 1) / GPD_ENVS;
    *threads = GPD_ENVS * n;
}

// Dynamic shared memory of that launch: the two pose buffers of the PYB
// family with n > 1, else none.
static size_t gpd_env_ctrl_step_smem(int n, int pyb) {
    return pyb && n > 1 ? (size_t)2 * n * GPD_PS * GPD_ENVS * sizeof(float)
                        : 0;
}

// Blocks of that launch (pyb: the PYB family) that one SM of the current
// device holds at once, for the kernel as built.  Returns the CUDA error.
extern "C" int gpd_env_ctrl_step_occupancy(int n, int pyb,
                                           int* blocks_per_sm) {
    *blocks_per_sm = 0;
    if (n < 1 || n > GPD_MAX_DRONES) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, env_ctrl_step_kernel, GPD_ENVS * n,
        gpd_env_ctrl_step_smem(n, pyb));
}

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
    const int n = p->n_drones;
    if (n < 1 || n > GPD_MAX_DRONES) return (int)cudaErrorInvalidValue;
    int blocks, threads;
    gpd_env_ctrl_step_geometry(B, n, &blocks, &threads);
    env_ctrl_step_kernel<<<blocks, threads,
                           gpd_env_ctrl_step_smem(n, p->pyb.enabled != 0),
                           (cudaStream_t)stream>>>(
        state, act, pid_in, last_rpm, out, rpm_out, pid_out, obs12, B, ld,
        *p);
    return (int)cudaGetLastError();
}
