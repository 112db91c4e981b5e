// dyn_ctrl_step: one DYN control step (all substeps) per launch.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_dyn.py:
// dyn_ctrl_step.  One thread per (env x drone) column of the (16, B) state
// block; the column index is the contiguous one, so every row load and
// store is coalesced.  The drone's state stays in registers through all
// substeps.  Tail threads are masked; B needs no padding.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at
// the rollout's 4096-16384 columns neither bytes nor operations.  One warp
// costs within 13% of 16384 columns: about 1.0-1.3 us of launch floor, then
// one memory round trip and one thread's chain of eight substeps, each
// waiting in program order on the slow-path branch regions of an IEEE
// reciprocal, a square root, a sine/cosine reduction and a division.  The
// kernel shortens that chain without changing a result (ops/kernel_dyn.py,
// gpd_dyn_substep).
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

__global__ void dyn_ctrl_step_kernel(const float* __restrict__ state,
                                     const float* __restrict__ rpm,
                                     float* __restrict__ out,
                                     float* __restrict__ obs12, int B, int ld,
                                     const __grid_constant__ GpdStepParams p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= B) return;

    float s[GPD_S];
#pragma unroll
    for (int k = 0; k < 13; ++k) s[k] = state[(size_t)k * ld + col];
    s[13] = s[14] = s[15] = 0.0f;
    const float r0 = rpm[col], r1 = rpm[(size_t)ld + col],
                r2 = rpm[(size_t)2 * ld + col], r3 = rpm[(size_t)3 * ld + col];

    float thrust, xt, yt, zt;
    gpd_motor_mix(p.drone, r0, r1, r2, r3, thrust, xt, yt, zt);
    gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust, xt,
                     yt, zt);

#pragma unroll
    for (int k = 0; k < GPD_S; ++k) out[(size_t)k * ld + col] = s[k];

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

// Blocks and threads per block of the launch gpd_dyn_ctrl_step makes over B
// columns, one (env, drone) each: GPD_DYN_THREADS a block.  `n` is not read.
extern "C" void gpd_dyn_ctrl_step_geometry(int B, int n, int* blocks,
                                           int* threads) {
    (void)n;
    *threads = GPD_DYN_THREADS;
    *blocks = (B + *threads - 1) / *threads;
}

// Launches on `stream`, does not synchronise, allocates nothing.  All
// blocks share the row stride `ld` (elements between rows).  `obs12` may be
// NULL.  Returns cudaGetLastError().
extern "C" int gpd_dyn_ctrl_step(const float* state, const float* rpm,
                                 float* out, float* obs12, int B, int ld,
                                 const GpdStepParams* p, void* stream) {
    if (B <= 0) return 0;
    int blocks, threads;
    gpd_dyn_ctrl_step_geometry(B, 1, &blocks, &threads);
    dyn_ctrl_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        state, rpm, out, obs12, B, ld, *p);
    return (int)cudaGetLastError();
}
