// fused_env_step: the whole env control step in one launch.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_fused.py:
// fused_env_step, for DYN physics with RPM / ONE_D_RPM actions and the
// Hover / MultiHover tasks.  One thread per env; rows are drone-major and
// the env index is the contiguous one, so every load and store is
// coalesced.
//
//   carry (RC, B): per drone [state16 | last_rpm4 | history buf_rows],
//                  then the substep-counter row (float)
//   outs  (RO, B): per drone [obs12 | history buf_rows],
//                  then reward, terminated, truncated rows (floats)
//
// Pass 1 steps each drone with its state in registers, parks the stepped
// state in the thread's own column of the output carry, and accumulates
// the task's sums.  Once the env's done flag is known, pass 2 re-reads that
// column, selects the reset state for done envs, and writes the carry and
// the observation rows from the SELECTED state.  The history ring moves
// through memory row by row, never through registers.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

__global__ void fused_env_step_kernel(const float* __restrict__ carry,
                                      const float* __restrict__ act,
                                      float* carry_out,
                                      float* __restrict__ outs, int B, int ld,
                                      const __grid_constant__ GpdStepParams p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= B) return;

    const int n = p.n_drones, A = p.act_dim, buf_rows = p.buf_rows;
    const int per_drone = GPD_S + GPD_LR + buf_rows;
    const int buf_off = GPD_S + GPD_LR;
    const int obs_per = 12 + buf_rows;
#define AT(ptr, row) (ptr)[(size_t)(row) * ld + col]

    // ---- pass 1: action -> rpm, physics, task sums ----
    GpdPostAcc acc;
    gpd_post_init(acc);
    for (int d = 0; d < n; ++d) {
        const int base = d * per_drone;
        float s[GPD_S];
#pragma unroll
        for (int k = 0; k < 13; ++k) s[k] = AT(carry, base + k);
        s[13] = s[14] = s[15] = 0.0f;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rpm[4];
        for (int k = 0; k < A && k < 4; ++k) a[k] = AT(act, d * A + k);
        gpd_action_to_rpm(p, a, rpm);

        float thrust, xt, yt, zt;
        gpd_motor_mix(p.drone, rpm[0], rpm[1], rpm[2], rpm[3], thrust, xt,
                      yt, zt);
        gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust,
                         xt, yt, zt);
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) AT(carry_out, base + k) = s[k];

        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        if (p.task_id == GPD_TASK_HOVER)
            gpd_hover_row_post(p, d, s[0], s[1], s[2], roll, pitch, acc);
        else
            gpd_multihover_row_post(p, d, s[0], s[1], s[2], roll, pitch, acc);
    }

    // the task sees the PRE-increment substep counter
    const float sc = AT(carry, n * per_drone);
    bool term, trunc;
    gpd_post_finish(p, acc, sc, term, trunc);
    const bool done = term | trunc;

    // ---- pass 2: auto-reset select, carry and observation rows ----
    for (int d = 0; d < n; ++d) {
        const int base = d * per_drone, ob = d * obs_per;
        float s[GPD_S];
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) {
            s[k] = done ? p.init16[d][k] : AT(carry_out, base + k);
            AT(carry_out, base + k) = s[k];
        }
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rpm[4];
        for (int k = 0; k < A && k < 4; ++k) a[k] = AT(act, d * A + k);
        gpd_action_to_rpm(p, a, rpm);
#pragma unroll
        for (int k = 0; k < GPD_LR; ++k)
            AT(carry_out, base + GPD_S + k) = done ? 0.0f : rpm[k];

        // observation rows from the SELECTED (post-reset) state
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                             s[7], s[8], s[9], s[13], s[14], s[15]};
#pragma unroll
        for (int k = 0; k < 12; ++k) AT(outs, ob + k) = o[k];

        // history ring, oldest first: drop the oldest action, append the
        // new one; a done env's ring is zeroed
        for (int k = 0; k < buf_rows; ++k) {
            float v = 0.0f;
            if (!done)
                v = k + A < buf_rows ? AT(carry, base + buf_off + k + A)
                                     : AT(act, d * A + (k + A - buf_rows));
            AT(carry_out, base + buf_off + k) = v;
            AT(outs, ob + 12 + k) = v;
        }
    }
    AT(carry_out, n * per_drone) = done ? 0.0f : sc + (float)p.n_substeps;
    const int ro = n * obs_per;
    AT(outs, ro) = acc.reward;
    AT(outs, ro + 1) = term ? 1.0f : 0.0f;
    AT(outs, ro + 2) = trunc ? 1.0f : 0.0f;
#undef AT
}

extern "C" int gpd_params_size() { return (int)sizeof(GpdStepParams); }

// Launches on `stream`, does not synchronise, allocates nothing.  All four
// blocks share the row stride `ld` (elements between rows); `carry_out`
// must not alias `carry`.  Returns cudaGetLastError().
extern "C" int gpd_fused_env_step(const float* carry, const float* act,
                                  float* carry_out, float* outs, int B, int ld,
                                  const GpdStepParams* p, void* stream) {
    if (B <= 0) return 0;
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    fused_env_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        carry, act, carry_out, outs, B, ld, *p);
    return (int)cudaGetLastError();
}
