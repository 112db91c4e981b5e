// fused_env_step: the whole env control step in one launch.
//
// Hopper counterpart of the Pallas TPU kernel ops/pallas_fused.py:
// fused_env_step, for every physics mode (DYN and the PYB family) with
// every action type (RPM, ONE_D_RPM and the PID family PID / VEL /
// ONE_D_PID, whose embedded DSL-PID ticks in-kernel) and the Hover /
// MultiHover / Routing tasks.
//
//   carry (RC, B): per drone [state16 | last_rpm4 | pid9 (PID family only)
//                  | history buf_rows], then the substep-counter row (float)
//   outs  (RO, B): per drone [obs12 | history buf_rows | task extras],
//                  then reward, terminated, truncated rows (floats)
//
// One thread per (env, drone).  A block holds GPD_ENVS = 32 envs of N
// drones, 32 * N threads, warp w being drone w of the block's envs: rows
// are drone-major and the env index is the contiguous one, so every row
// load or store of a warp is one 128-byte line.  The grid is ceil(B / 32)
// blocks, fixed by the launcher from B and N.  What bounds the kernel is
// the dependent chain of one thread (operations, not bytes, under the PYB
// family); the layout spreads 4096 envs of 4 drones over 128 blocks of 4
// warps instead of 32 blocks, with a chain of one drone each.
//
// Since that chain waits on latency, warps an SM are what hide it, and the
// kernel is built for two blocks of the largest fleet an SM: at most 128
// registers a thread.  A fleet of 4 then fits 4 blocks (16 warps) an SM,
// and 16384 such fleets (512 blocks) run in one wave of the card's 528.
// The budget is met with short live ranges, not spills: the PID rows are
// stored right after the tick, the PYB pair loop reads both poses of a
// pair from the shared pose buffer, and the contact solve keeps its rim
// and obstacle constants in tables in local memory (drone_kernels.cuh).
//
// Pass 1, per thread: action -> rpm (the embedded PID when the family has
// one), then the physics on the drone's state in registers: the DYN
// substeps alone, or the coupled PYB substeps (gpd_pyb_ctrl_substeps),
// which exchange poses with the env's other drones through shared memory.
// The drone's share of the task's sums and its stepped position go to
// shared memory; after a barrier one thread per env (warp 0) adds them in
// drone order and routing's pair penalties in pair order, exactly the
// additions of a loop over drones, and publishes the done flag.  Pass 2,
// per thread again: the auto-reset select of the state still in registers,
// the carry and observation rows, the history ring (its loads issued in
// chunks of GPD_RING_CHUNK), and routing's extra rows from the selected
// positions of all drones, shared after one more barrier.
//
// Threads past the last env go through every barrier and load and store
// nothing.  Shared memory (dynamic, sized by the launcher), all
// [.][GPD_ENVS]: task shares 4 x N, positions 3 x N, done 1, and under the
// PYB family with N > 1 the two pose buffers of gpd_pyb_ctrl_substeps.
#include <cuda_runtime.h>

#include "drone_kernels.cuh"

#define GPD_RING_CHUNK 16  // history-ring loads in flight per thread

__global__ void __launch_bounds__(GPD_ENVS * GPD_MAX_DRONES, 2)
fused_env_step_kernel(const float* __restrict__ carry,
                      const float* __restrict__ act,
                      float* __restrict__ carry_out,
                      float* __restrict__ outs, int B, int ld,
                      const __grid_constant__ GpdStepParams p) {
    extern __shared__ float gpd_sh[];
    const int n = p.n_drones, A = p.act_dim, buf_rows = p.buf_rows;
    const int d = threadIdx.x / GPD_ENVS, lane = threadIdx.x % GPD_ENVS;
    const int col = blockIdx.x * GPD_ENVS + lane;
    const bool valid = col < B;
    const bool has_pid = p.act_type >= GPD_ACT_PID;
    const int pid_off = GPD_S + GPD_LR;
    const int buf_off = pid_off + (has_pid ? GPD_PR : 0);
    const int per_drone = buf_off + buf_rows;
    const int obs_per = 12 + buf_rows + p.n_extra;
    const int base = d * per_drone, ob = d * obs_per;
    const bool pyb = p.pyb.enabled != 0;
    const bool drag = pyb && p.pyb.drag != 0;
    float* sh_share = gpd_sh;                    // [4][n][GPD_ENVS]
    float* sh_pos = sh_share + 4 * n * GPD_ENVS; // [n][3][GPD_ENVS]
    float* sh_done = sh_pos + 3 * n * GPD_ENVS;  // [GPD_ENVS]
    float* sh_pose = sh_done + GPD_ENVS;         // PYB, n > 1
#define AT(ptr, row) (ptr)[(size_t)(row) * ld + col]
#define SH(arr, i, j) (arr)[((i) * n + (j)) * GPD_ENVS + lane]
#define POS(j, k) sh_pos[((j) * 3 + (k)) * GPD_ENVS + lane]

    // ---- pass 1: action -> rpm, physics, the drone's task share ----
    // every load of pass 1 first, so that they are in flight together; a
    // thread past the last env steps a drone at rest at the origin
    float s[GPD_S], a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rpm[4];
    float w[3] = {0.0f, 0.0f, 0.0f}, last[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float pid[GPD_PR];
#pragma unroll
    for (int k = 0; k < GPD_S; ++k) s[k] = k == 6 ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < GPD_PR; ++k) pid[k] = 0.0f;
    if (valid) {
#pragma unroll
        for (int k = 0; k < 13; ++k) s[k] = AT(carry, base + k);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (k < A) a[k] = AT(act, d * A + k);
        if (has_pid) {
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k)
                pid[k] = AT(carry, base + pid_off + k);
        }
        if (pyb) {
#pragma unroll
            for (int k = 0; k < 3; ++k) w[k] = AT(carry, base + 13 + k);
        }
        if (drag) {
#pragma unroll
            for (int k = 0; k < GPD_LR; ++k)
                last[k] = AT(carry, base + GPD_S + k);
        }
    }
    if (has_pid) {
        // embedded DSL-PID tick (always the CF2X controller); its new rows
        // are stored now, so that nothing of them stays live through the
        // physics: pass 2 zeroes them for a done env
        float tgt[GPD_TR], npid[GPD_PR];
        gpd_pid_setpoints(p, s, a, tgt);
        gpd_pid_tick(p.pid, p.ctrl_dt, s, pid, tgt, rpm, npid);
        if (valid) {
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k)
                AT(carry_out, base + pid_off + k) = npid[k];
        }
    } else {
        gpd_action_to_rpm(p, a, rpm);
    }

    if (pyb) {
        // coupled physics on the live state [p q v w_world]; the drag of
        // substep 0 uses the previous control step's rpm (zero after an
        // auto-reset); the rpy_rates rows 10-12 pass through
        float st[GPD_PS];
#pragma unroll
        for (int k = 0; k < 10; ++k) st[k] = s[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) st[10 + k] = w[k];
        gpd_pyb_ctrl_substeps(p, st, rpm, last, drag, sh_pose, d, lane);
#pragma unroll
        for (int k = 0; k < 10; ++k) s[k] = st[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) s[13 + k] = st[10 + k];
    } else {
        float thrust, xt, yt, zt;
        gpd_motor_mix(p.drone, rpm[0], rpm[1], rpm[2], rpm[3], thrust, xt,
                      yt, zt);
        gpd_dyn_substeps(p.drone, p.n_substeps, p.dt, p.half_dt, s, thrust,
                         xt, yt, zt);
    }
    {
        GpdPostShare share;
        gpd_post_share(p, d, s, share);
        SH(sh_share, 0, d) = share.r;
        SH(sh_share, 1, d) = share.x;
        SH(sh_share, 2, d) = share.out ? 1.0f : 0.0f;
        SH(sh_share, 3, d) = share.in ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) POS(d, k) = s[k];
    }
    GPD_SYNC();

    // ---- the env's sums, flags and counter: one thread per env ----
    if (d == 0) {
        GpdPostAcc acc;
        gpd_post_init(acc);
#pragma unroll 1
        for (int j = 0; j < n; ++j) {
            GpdPostShare share;
            share.r = SH(sh_share, 0, j);
            share.x = SH(sh_share, 1, j);
            share.out = SH(sh_share, 2, j) != 0.0f;
            share.in = SH(sh_share, 3, j) != 0.0f;
            gpd_post_add(p, j, share, acc);
        }
        if (p.task_id == GPD_TASK_ROUTING)
            gpd_routing_pairs(p, sh_pos + lane, acc);
        // the task sees the PRE-increment substep counter
        const float sc = valid ? AT(carry, n * per_drone) : 0.0f;
        bool term, trunc;
        gpd_post_finish(p, acc, sc, term, trunc);
        const bool done = term | trunc;
        sh_done[lane] = done ? 1.0f : 0.0f;
        if (valid) {
            AT(carry_out, n * per_drone) =
                done ? 0.0f : sc + (float)p.n_substeps;
            const int ro = n * obs_per;
            AT(outs, ro) = acc.reward;
            AT(outs, ro + 1) = term ? 1.0f : 0.0f;
            AT(outs, ro + 2) = trunc ? 1.0f : 0.0f;
        }
    }
    GPD_SYNC();
    const bool done = sh_done[lane] != 0.0f;

    // ---- pass 2: auto-reset select, carry and observation rows ----
#pragma unroll
    for (int k = 0; k < GPD_S; ++k) s[k] = done ? p.init16[d][k] : s[k];
    if (valid) {
#pragma unroll
        for (int k = 0; k < GPD_S; ++k) AT(carry_out, base + k) = s[k];
        // a done env's last rpm and PID rows are zeroed (a live env's PID
        // rows were stored after the tick)
#pragma unroll
        for (int k = 0; k < GPD_LR; ++k)
            AT(carry_out, base + GPD_S + k) = done ? 0.0f : rpm[k];
        if (has_pid && done) {
#pragma unroll
            for (int k = 0; k < GPD_PR; ++k)
                AT(carry_out, base + pid_off + k) = 0.0f;
        }

        // observation rows from the SELECTED (post-reset) state
        float roll, pitch, yaw;
        gpd_quat_rpy(s[3], s[4], s[5], s[6], roll, pitch, yaw);
        const float o[12] = {s[0], s[1], s[2], roll,  pitch, yaw,
                             s[7], s[8], s[9], s[13], s[14], s[15]};
#pragma unroll
        for (int k = 0; k < 12; ++k) AT(outs, ob + k) = o[k];

        // history ring, oldest first: drop the oldest action, append the
        // new RAW one; a done env's ring is zeroed.  Each chunk's loads are
        // issued before its stores.
#pragma unroll 1
        for (int k0 = 0; k0 < buf_rows; k0 += GPD_RING_CHUNK) {
            float v[GPD_RING_CHUNK];
#pragma unroll
            for (int u = 0; u < GPD_RING_CHUNK; ++u) {
                const int k = k0 + u;
                v[u] = 0.0f;
                if (!done && k < buf_rows)
                    v[u] = k + A < buf_rows
                               ? AT(carry, base + buf_off + k + A)
                               : AT(act, d * A + (k + A - buf_rows));
            }
#pragma unroll
            for (int u = 0; u < GPD_RING_CHUNK; ++u) {
                const int k = k0 + u;
                if (k < buf_rows) {
                    AT(carry_out, base + buf_off + k) = v[u];
                    AT(outs, ob + 12 + k) = v[u];
                }
            }
        }
    }
    if (p.n_extra > 0) {
        // routing: goal vector and nearest neighbour from the selected
        // positions of ALL drones of the env (the stepped ones were last
        // read before the done barrier)
#pragma unroll
        for (int k = 0; k < 3; ++k) POS(d, k) = s[k];
        GPD_SYNC();
        if (valid) {
            float e[6];
            gpd_routing_extra_obs(p, sh_pos + lane, d, e);
#pragma unroll
            for (int k = 0; k < 6; ++k) AT(outs, ob + 12 + buf_rows + k) = e[k];
        }
    }
#undef POS
#undef SH
#undef AT
}

extern "C" int gpd_params_size() { return (int)sizeof(GpdStepParams); }

// Blocks and threads per block of the launch gpd_fused_env_step makes over
// B envs of n drones: GPD_ENVS envs a block, one thread per (env, drone).
extern "C" void gpd_fused_env_step_geometry(int B, int n, int* blocks,
                                            int* threads) {
    *blocks = (B + GPD_ENVS - 1) / GPD_ENVS;
    *threads = GPD_ENVS * n;
}

// Dynamic shared memory of that launch: task shares, positions and the
// done flag, and under the PYB family with n > 1 the two pose buffers.
static size_t gpd_fused_env_step_smem(int n, int pyb) {
    size_t floats = (size_t)(7 * n + 1) * GPD_ENVS;
    if (pyb && n > 1) floats += (size_t)2 * n * GPD_PS * GPD_ENVS;
    return floats * sizeof(float);
}

// Blocks of that launch (pyb: the PYB family) that one SM of the current
// device holds at once, for the kernel as built.  Returns the CUDA error.
extern "C" int gpd_fused_env_step_occupancy(int n, int pyb,
                                            int* blocks_per_sm) {
    *blocks_per_sm = 0;
    if (n < 1 || n > GPD_MAX_DRONES) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_env_step_kernel, GPD_ENVS * n,
        gpd_fused_env_step_smem(n, pyb));
}

// Launches on `stream`, does not synchronise, allocates nothing.  All four
// blocks share the row stride `ld` (elements between rows); `carry_out`
// must not alias `carry`.  Returns cudaGetLastError().
extern "C" int gpd_fused_env_step(const float* carry, const float* act,
                                  float* carry_out, float* outs, int B, int ld,
                                  const GpdStepParams* p, void* stream) {
    if (B <= 0) return 0;
    const int n = p->n_drones;
    if (n < 1 || n > GPD_MAX_DRONES) return (int)cudaErrorInvalidValue;
    int blocks, threads;
    gpd_fused_env_step_geometry(B, n, &blocks, &threads);
    fused_env_step_kernel<<<blocks, threads,
                            gpd_fused_env_step_smem(n, p->pyb.enabled != 0),
                            (cudaStream_t)stream>>>(carry, act, carry_out,
                                                    outs, B, ld, *p);
    return (int)cudaGetLastError();
}
