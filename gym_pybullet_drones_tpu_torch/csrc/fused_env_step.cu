// fused_env_step: the whole env control step in one launch.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_fused.py:
// fused_env_step, for every physics mode (DYN and the PYB family) with
// every action type (RPM, ONE_D_RPM and the PID family PID / VEL /
// ONE_D_PID, whose embedded DSL-PID ticks in-kernel) and the Hover /
// MultiHover / Routing tasks.  One thread per env; rows are drone-major and
// the env index is the contiguous one, so every load and store is
// coalesced.
//
//   carry (RC, B): per drone [state16 | last_rpm4 | pid9 (PID family only)
//                  | history buf_rows], then the substep-counter row (float)
//   outs  (RO, B): per drone [obs12 | history buf_rows | task extras],
//                  then reward, terminated, truncated rows (floats)
//
// Pass 1 steps each drone with its state in registers, parks the stepped
// state, the applied rpm and the new PID rows in the thread's own column of
// the output carry, and accumulates the task's sums.  Cross-drone terms
// (routing's pairwise separation) re-read the parked positions.  Once the
// env's done flag is known, pass 2 re-reads that column, selects the reset
// state for done envs, and writes the carry and the observation rows from
// the SELECTED state; routing's extra rows (goal vector, nearest neighbour)
// follow from the selected positions of all drones.  The history ring moves
// through memory row by row, never through registers.
//
// Under the PYB family the drones of an env are coupled (downwash,
// drone-drone contact), so pass 1 splits: every drone's action becomes rpm
// first, the live state of ALL drones (13 floats each: the world ang_v rows
// are carried state here, last_rpm feeds the stale drag of substep 0, the
// rpy_rates rows pass through) waits in per-thread local arrays while
// gpd_pyb_substep_all runs the substeps, and the parking and the task sums
// follow.  Pass 2 is the same for both families.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

// One stepped drone's share of the task's sums: s = [p3 q4 ...], v = its
// stepped velocity.
static __device__ __forceinline__ void fused_post_drone(
    const GpdStepParams& p, int d, const float* s, const float* v,
    GpdPostAcc& acc) {
    float roll, pitch, yaw;
    gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
    if (p.task_id == GPD_TASK_HOVER)
        gpd_hover_row_post(p, d, s[0], s[1], s[2], roll, pitch, acc);
    else if (p.task_id == GPD_TASK_MULTIHOVER)
        gpd_multihover_row_post(p, d, s[0], s[1], s[2], roll, pitch, acc);
    else
        gpd_routing_row_post(p, d, s[0], s[1], s[2], v[0], v[1], v[2], roll,
                             pitch, acc);
}

__global__ void fused_env_step_kernel(const float* __restrict__ carry,
                                      const float* __restrict__ act,
                                      float* carry_out,
                                      float* __restrict__ outs, int B, int ld,
                                      const __grid_constant__ GpdStepParams p) {
    const int col = blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= B) return;

    const int n = p.n_drones, A = p.act_dim, buf_rows = p.buf_rows;
    const bool has_pid = p.act_type >= GPD_ACT_PID;
    const int pid_off = GPD_S + GPD_LR;
    const int buf_off = pid_off + (has_pid ? GPD_PR : 0);
    const int per_drone = buf_off + buf_rows;
    const int obs_per = 12 + buf_rows + p.n_extra;
#define AT(ptr, row) (ptr)[(size_t)(row) * ld + col]

    // ---- pass 1: action -> rpm, physics, task sums ----
    const bool pyb = p.pyb.enabled != 0;
    const bool drag = pyb && p.pyb.drag != 0;
    float st[GPD_MAX_DRONES][GPD_PS];
    float rpms[GPD_MAX_DRONES][4], last[GPD_MAX_DRONES][4];
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
        if (has_pid) {
            // embedded DSL-PID tick (always the CF2X controller)
            float pid[GPD_PR], npid[GPD_PR], tgt[GPD_TR];
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k)
                pid[k] = AT(carry, base + pid_off + k);
            gpd_pid_setpoints(p, s, a, tgt);
            gpd_pid_tick(p.pid, p.ctrl_dt, s, pid, tgt, rpm, npid);
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k)
                AT(carry_out, base + pid_off + k) = npid[k];
        } else {
            gpd_action_to_rpm(p, a, rpm);
        }
#pragma unroll
        for (int k = 0; k < GPD_LR; ++k) AT(carry_out, base + GPD_S + k) = rpm[k];

        if (pyb) {
            // coupled physics: hold the live state until all drones have
            // their rpm; rpy_rates pass through
#pragma unroll
            for (int k = 0; k < 4; ++k) rpms[d][k] = rpm[k];
#pragma unroll
            for (int k = 0; k < 10; ++k) st[d][k] = s[k];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                st[d][10 + k] = AT(carry, base + 13 + k);
                AT(carry_out, base + 10 + k) = s[10 + k];
            }
            if (drag) {
#pragma unroll
                for (int k = 0; k < GPD_LR; ++k)
                    last[d][k] = AT(carry, base + GPD_S + k);
            }
            continue;
        }
        float thrust, xt, yt, zt;
        gpd_motor_mix(p.drone, rpm[0], rpm[1], rpm[2], rpm[3], thrust, xt,
                      yt, zt);
        gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust,
                         xt, yt, zt);
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) AT(carry_out, base + k) = s[k];
        fused_post_drone(p, d, s, s + 7, acc);
    }
    if (pyb) {
        // the drag of substep 0 uses the previous control step's rpm (zero
        // after an auto-reset), later substeps the new one
#pragma unroll 1
        for (int i = 0; i < p.n_substeps; ++i)
            gpd_pyb_substep_all(p, st, rpms, (drag && i == 0) ? last : rpms);
#pragma unroll 1
        for (int d = 0; d < n; ++d) {
            const int base = d * per_drone;
            const float* s = st[d];
#pragma unroll
            for (int k = 0; k < 10; ++k) AT(carry_out, base + k) = s[k];
#pragma unroll
            for (int k = 0; k < 3; ++k)
                AT(carry_out, base + 13 + k) = s[10 + k];
            fused_post_drone(p, d, s, s + 7, acc);
        }
    }
    if (p.task_id == GPD_TASK_ROUTING)
        gpd_routing_pairs(p, carry_out + col, (size_t)ld, per_drone, acc);

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
        if (done) {
            // a done env's last rpm and PID rows are zeroed
#pragma unroll
            for (int k = 0; k < GPD_LR; ++k)
                AT(carry_out, base + GPD_S + k) = 0.0f;
            if (has_pid) {
#pragma unroll
                for (int k = 0; k < GPD_PR; ++k)
                    AT(carry_out, base + pid_off + k) = 0.0f;
            }
        }

        // observation rows from the SELECTED (post-reset) state
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                             s[7], s[8], s[9], s[13], s[14], s[15]};
#pragma unroll
        for (int k = 0; k < 12; ++k) AT(outs, ob + k) = o[k];

        // history ring, oldest first: drop the oldest action, append the
        // new RAW one; a done env's ring is zeroed
        for (int k = 0; k < buf_rows; ++k) {
            float v = 0.0f;
            if (!done)
                v = k + A < buf_rows ? AT(carry, base + buf_off + k + A)
                                     : AT(act, d * A + (k + A - buf_rows));
            AT(carry_out, base + buf_off + k) = v;
            AT(outs, ob + 12 + k) = v;
        }
    }
    if (p.n_extra > 0) {
        // routing: goal vector and nearest neighbour from the selected
        // positions of ALL drones, which pass 2 has just written
        for (int d = 0; d < n; ++d) {
            float e[6];
            gpd_routing_extra_obs(p, carry_out + col, (size_t)ld, per_drone,
                                  d, e);
#pragma unroll
            for (int k = 0; k < 6; ++k)
                AT(outs, d * obs_per + 12 + buf_rows + k) = e[k];
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
