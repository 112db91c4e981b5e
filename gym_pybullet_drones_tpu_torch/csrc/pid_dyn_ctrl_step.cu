// pid_dyn_ctrl_step: one cascaded DSL-PID tick, then one DYN control step
// (all substeps), per launch.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_pid.py:
// pid_dyn_ctrl_step.  One thread per (env x drone) column; the column index
// is the contiguous one, so every row load and store is coalesced.  The
// drone's state, PID scratch and setpoints stay in registers from the
// position loop through the last substep.  Tail threads are masked; B needs
// no padding.
//
//   state (16, B): pos3 quat4 vel3 rpy_rates3 ang_v3 (ang_v is never read)
//   pid   (9, B):  last_rpy3 integral_pos_e3 integral_rpy_e3
//   tgt   (12, B): target pos3 rpy3 vel3 rpy_rates3
//   -> state' (16, B), pid' (9, B), rpm (4, B) [, obs12 (12, B)]
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): as
// dyn_ctrl_step, the launch floor and one thread's chain, not bytes or
// operations, at the rollout's 16384 columns; the tick's own chain adds
// about 2 us before the substeps.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

__global__ void pid_dyn_ctrl_step_kernel(const float* __restrict__ state,
                                         const float* __restrict__ pid_in,
                                         const float* __restrict__ tgt_in,
                                         float* __restrict__ out,
                                         float* __restrict__ pid_out,
                                         float* __restrict__ rpm_out,
                                         float* __restrict__ obs12, int B,
                                         int ld,
                                         const __grid_constant__ GpdStepParams p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= B) return;

    float s[GPD_S], pid[GPD_PR], tgt[GPD_TR], npid[GPD_PR], rpm[4];
#pragma unroll
    for (int k = 0; k < 13; ++k) s[k] = state[(size_t)k * ld + col];
    s[13] = s[14] = s[15] = 0.0f;
#pragma unroll
    for (int k = 0; k < GPD_PR; ++k) pid[k] = pid_in[(size_t)k * ld + col];
#pragma unroll
    for (int k = 0; k < GPD_TR; ++k) tgt[k] = tgt_in[(size_t)k * ld + col];

    gpd_pid_tick(p.pid, p.ctrl_dt, s, pid, tgt, rpm, npid);

    float thrust, xt, yt, zt;
    gpd_motor_mix(p.drone, rpm[0], rpm[1], rpm[2], rpm[3], thrust, xt, yt,
                  zt);
    gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust, xt,
                     yt, zt);

#pragma unroll
    for (int k = 0; k < GPD_S; ++k) out[(size_t)k * ld + col] = s[k];
#pragma unroll
    for (int k = 0; k < GPD_PR; ++k) pid_out[(size_t)k * ld + col] = npid[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) rpm_out[(size_t)k * ld + col] = rpm[k];

    if (obs12 != nullptr) {
        // the 12-row kinematic observation block of the RL tasks:
        // pos, rpy, vel, world ang-vel
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                             s[7], s[8], s[9], s[13], s[14], s[15]};
#pragma unroll
        for (int k = 0; k < 12; ++k) obs12[(size_t)k * ld + col] = o[k];
    }
}

extern "C" int gpd_params_size() { return (int)sizeof(GpdStepParams); }

// Blocks and threads per block of the launch gpd_pid_dyn_ctrl_step makes over B
// columns, one (env, drone) each: GPD_DYN_THREADS a block.  `n` is not read.
extern "C" void gpd_pid_dyn_ctrl_step_geometry(int B, int n, int* blocks,
                                               int* threads) {
    (void)n;
    *threads = GPD_DYN_THREADS;
    *blocks = (B + *threads - 1) / *threads;
}

// Launches on `stream`, does not synchronise, allocates nothing.  All
// blocks share the row stride `ld` (elements between rows).  `obs12` may be
// NULL.  Returns cudaGetLastError().
extern "C" int gpd_pid_dyn_ctrl_step(const float* state, const float* pid_in,
                                     const float* tgt_in, float* out,
                                     float* pid_out, float* rpm_out,
                                     float* obs12, int B, int ld,
                                     const GpdStepParams* p, void* stream) {
    if (B <= 0) return 0;
    int blocks, threads;
    gpd_pid_dyn_ctrl_step_geometry(B, 1, &blocks, &threads);
    pid_dyn_ctrl_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        state, pid_in, tgt_in, out, pid_out, rpm_out, obs12, B, ld, *p);
    return (int)cudaGetLastError();
}
