#!/usr/bin/env python3
"""Checks of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the hand-written CUDA kernels from this checkout and holds the
port's paths on the card against their plain versions and the CPU.  It
measures nothing but the kernel table: speed end to end is the
benchmark's (`python3 -m portbench.run`).  One JSON object a line, in
this order (each phase raises on a failed check; exit code 0 and the
last line `{"ok": true, ...}` mean all passed):

- `env`, `build`: versions; each kernel's registers, stack and spills.
- `kernel_checks`: every kernel against its plain version over the
  physics modes, drone counts, actions and shapes; launch floors; the
  geometry subsets (1-8 drones packed, 33 envs of a 1000-env launch bit
  for bit).
- `rollout_hover`, `rollout_multihover`, `rollout_routing`,
  `rollout_routing_pyb`, `rollout_hover_pyb_aero`: zero-action episodes,
  a landing, random rollouts through `make_fused_rollout` against
  `make_batched_step`, launch counts.
- `ppo_update_parity`, `ppo_hover8192`, `ppo_hover_pyb_learn`,
  `ppo_kernel_checks`: one update on the card against the CPU; the
  trainers' launch counts and finite metrics; K2 at their shapes.
- `population_update_parity`, `ppo_population8x1024`,
  `population_kernel_checks`, `ppo_bf16_parity`: K policies against the
  CPU and against their single updates; one K2 launch for all members;
  a bf16 update against the CPU.
- `render_checks`, `hover256_rgb`, `ppo_rgb_update_parity`, `ppo_rgb512`,
  `population_rgb_update_parity`, `ppo_population_rgb8x512`: the render
  kernel bit for bit; the RGB step and pixel PPO against the CPU; K1
  and render launch counts.
- `reset_noise`, `gym_adapter`, `examples`: randomized resets against
  the CPU, draws bit for bit; the class adapters and cameras; pid.py and
  swarm.py.
- `routing_learn`, `host_loops`: the routing run's updates and
  evaluations; CFAviary, cf.py, BetaAviary over loopback, the firmware
  oracle, debug.py's probes, checkpoints resumed bit for bit.
- `sharded`: 2 gloo ranks (and NCCL where two cards are visible) on the
  JAX package's multi-chip matrix against one process; a population
  split by member; a checkpoint saved at 2 ranks, resumed at 2 and 1.
- `{"kernels": [...]}`: per kernel and main-path shape its device `ms`
  (a CUDA graph's replays), `eager_ms`, launch geometry, ptxas figures,
  for K2 and K5 the blocks an SM holds at once and the launch's waves,
  and its least time (`bound_ms`, `bound_by`) from
  `portbench/counts/work.py`'s peaks; then the card's name and power
  limit as nvidia-smi prints them; then `{"ok": true, "device": {...}}`.

It imports only torch, numpy, the port and `portbench.counts.work`.
"""
import copy
import dataclasses
import json
import re
import shutil
import socket
import struct
import subprocess
import sys

import numpy as np
import torch

from portbench.counts.work import (
    FP32_FLOPS_PER_S, HBM_BYTES_PER_S, ops_per_column, pyb_ops_per_env)

ATOL, RTOL = 2e-5, 1e-4     # kernel vs plain version, state and obs
# The embedded-PID paths multiply near-cancelling sums by gains of 20 000
# to 70 000, so their tolerances are the JAX package's own for these paths:
# observations and reward 5e-5 absolute; rpm rows 2e-5 relative, 0.5
# absolute; state rows 3e-4 / 3e-5; PID rows 3e-4 / 2e-5.
PID_OBS_TOL = (5e-5, 1e-4)  # (atol, rtol)
PID_RPM_TOL = (0.5, 2e-5)
PID_STATE_TOL = (3e-5, 3e-4)
PID_ROWS_TOL = (2e-5, 3e-4)
# The PYB family: contact impulses reach the angular velocity through 1/J
# (7e4 for a Crazyflie), so the world ang-vel rows get the JAX package's own
# tolerance for this kernel (tests/test_pallas.py:241-259).  A separated
# contact inside the speculative window is driven to the closing speed
# depth/dt, 240 x a difference of positions of order 1 m: the 0.5 ulp by
# which a fused and an unfused p + dt*v differ (6e-8) is 1.4e-5 of velocity
# on each of 8 substeps, so the velocity rows get 1e-4.  Every other row
# keeps ATOL, RTOL.
PYB_ANGV_TOL = (5e-4, 3e-4)
PYB_VEL_TOL = (1e-4, 1e-4)
# The host-side loops (CFAviary, debug.py's probes) run eager float32 on the
# card and on the CPU, free-running over about 480 ticks: the position within
# 1e-5 m and the probes' state within 1e-5, some 300x and 16x what the card
# showed (3.0e-8 m and 6.0e-7, NVIDIA H100 80GB HBM3, 700 W).
CF_POS_DRIFT = 1e-5
DEBUG_DRIFT = 1e-5
# Downwash switches on at dz > 0 with a magnitude ~ 1/dz^2 (10^3 m/s of
# velocity per control step at dz = 1 cm on a Crazyflie): two drones of an
# env within this height of each other [m] before the step are at a tie,
# and such an env is left out of a comparison if the two versions differ.
DW_TIE_MARGIN = 5e-3
SPHERE = (0.5, 0.5, 1.0, 0.15)             # obstacles of the PYB checks:
BOX = (-0.5, -0.5, 1.0, 0.15, 0.1, 0.2)    # centre + radius / half extents
FLAG_MARGIN = 1e-5          # a flag may differ only this close to a tie
NN_MARGIN = 1e-5            # nearest-neighbour tie: relative gap of the two
                            # smallest squared distances
SEED = 0
GEOMETRY_SUBSET = 33        # envs of a geometry case's second launch: 32 + 1
# One PPO update (24 control steps of 256 envs, 4 Adam steps) on the card
# against the same update on the CPU, from the same weights and draws: the
# rollout differs by the kernel's rounding against its plain version,
# which reaches the gradients; the weights move by about 1e-3 in all.
# Measured on an H100: 6e-8 on the weights, 1.9e-6 on v_loss (22.8), 2.7e-6
# on the last obs; the tolerances are tests/test_torch_ppo.py's.
PPO_PARAM_ATOL = 1e-6
PPO_METRIC_TOL = (1e-6, 1e-5)               # (atol, rtol)
# One bf16 update (compute_dtype="bfloat16") on the card against the same
# update on the CPU.  cuBLAS and the CPU sum a bf16 product's float32
# terms in other orders, so now and then one rounds it to the neighbouring
# bf16 number (2^-8 relative); Adam turns such a rounding of a gradient
# entry near zero into a step of up to lr (3e-4) a step.  The weights are
# held as tests/test_torch_ppo.py holds the port's bf16 update against the
# JAX package's: none off by more than BF16_PARAM_ATOL, at most
# BF16_FAR_SHARE of a tensor's entries off by more than BF16_PARAM_NEAR;
# the metrics to bf16's 2^-8 relative; the last obs to ATOL, RTOL.
BF16_PARAM_ATOL = 5e-4
BF16_PARAM_NEAR, BF16_FAR_SHARE = 2e-5, 0.05
BF16_METRIC_TOL = (1e-6, 2.0 ** -8)         # (atol, rtol)
# The port's Mellinger controller (float64, on the host) against the C++
# firmware oracle over tests/test_firmware_oracle.py's takeoff-goto-land
# loop, at that file's bound: control counts reach 6e4.
FIRMWARE_ORACLE_ATOL = 0.05


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound_ms(nbytes, ops):
    """Least time the card could take for `nbytes` moved once and `ops`
    float32 operations, at `portbench/counts/work.py`'s peaks, and which
    of the two binds.  A kernel's bytes count the rows the function uses,
    not what its blocks hold: the world ang-vel rows of the input state
    are recomputed, never read."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def pyb_case_states(rng, b, n, params, dw=False, packed=False,
                    spacing=0.45, min_dz=0.06, deep=True):
    """(n, 16, b) float32 state rows of n drones in b envs.  In eighths of
    the envs: on the ground (rim points within the contact window), tilted
    past the upright gate, a pair inside 2 * collision_r, stacked drones,
    drone 0 around the sphere (an eighth of those deep inside), drone 0
    around the box (inside and outside); the rest in free flight.  With
    `dw` (the downwash modes) the drones of one env keep apart in height:
    at equal heights the downwash is unbounded, and the close pair sits one
    above the other.  `packed` (for up to 8 drones) spaces the drones
    `spacing` [m] along x about x = 0, puts EVERY drone of the pair case in
    the contact window of the one before it (with `dw`: stacked upwards,
    6-13 cm apart), and with `dw` lifts drones until no two of an env are
    within `min_dz` [m] of one height: with 28 pairs an env, near-ties
    would be common otherwise.  Without `deep`, no drone sits deep inside
    the sphere: within a few centimetres of its centre the contact normal
    turns with the last bits of the offset, and one ulp of position moves
    the step's velocity by more than the tolerance.  Returns the states and
    {case: column slice}."""
    rc, h2 = params.collision_r, params.collision_h / 2
    st = np.stack([rand_state_rows(rng, b) for _ in range(n)])
    e = b // 8
    cases = {"ground": slice(0, e), "tilted": slice(e, 2 * e),
             "pair": slice(2 * e, 3 * e), "stacked": slice(3 * e, 4 * e),
             "sphere": slice(4 * e, 5 * e), "box": slice(5 * e, 6 * e)}
    g, t = cases["ground"], cases["tilted"]
    for d in range(n):
        # apart, unless a case says otherwise
        st[d, 0] += spacing * (d - (n - 1) / 2) if packed else 0.6 * d
        st[d, 2, g] = h2 - params.collision_z_offset \
            + rng.uniform(-0.02, 0.02, size=e) + (0.15 * d if dw else 0.0)
        st[d, 3:7, g] = rng.normal(size=(4, e)) * 0.03 \
            + np.array([[0.0]] * 3 + [[1.0]])
        roll = rng.uniform(1.7, 2.8, size=e) * rng.choice([-1, 1], size=e)
        st[d, 3:7, t] = np.stack([np.sin(roll / 2), 0 * roll, 0 * roll,
                                  np.cos(roll / 2)])
        st[d, 2, t] = 0.05 + rng.uniform(0, 0.1, size=e) \
            + (0.25 * d if dw else 0.0)
    if n > 1:
        pr, sk = cases["pair"], cases["stacked"]
        for d in range(1, n if packed else 2):
            off = rng.normal(size=(3, e))
            off *= rng.uniform(0.07, 0.14, size=e) \
                / np.linalg.norm(off, axis=0)
            if dw:
                off = np.stack([rng.uniform(-0.03, 0.03, size=e),
                                rng.uniform(-0.03, 0.03, size=e),
                                rng.uniform(0.06, 0.13, size=e)
                                * (1 if packed
                                   else rng.choice([-1, 1], size=e))])
            st[d, 0:3, pr] = st[d - 1, 0:3, pr] + off
        for d in range(1, n):
            st[d, 0:2, sk] = st[0, 0:2, sk] + rng.normal(size=(2, e)) * 0.02
            st[d, 2, sk] = st[0, 2, sk] + 0.35 * d \
                + rng.uniform(-0.05, 0.05, size=e)
    u = rng.normal(size=(3, e))
    u /= np.linalg.norm(u, axis=0)
    dist = SPHERE[3] + rc + rng.uniform(-0.04, 0.04, size=e)
    inside = rng.uniform(0.0, 0.05, size=e // 8)
    if deep:
        dist[:e // 8] = inside
    st[0, 0:3, cases["sphere"]] = np.asarray(SPHERE[:3])[:, None] + u * dist
    st[0, 0:3, cases["box"]] = np.asarray(BOX[:3])[:, None] \
        + np.asarray(BOX[3:])[:, None] * rng.uniform(-1.5, 1.5, size=(3, e))
    if packed and dw:
        order = np.argsort(st[:, 2], axis=0)
        z = np.take_along_axis(st[:, 2], order, axis=0)
        for k in range(1, n):
            z[k] = np.maximum(z[k], z[k - 1] + min_dz)
        np.put_along_axis(st[:, 2], order, z, axis=0)
    st[:, 3:7] /= np.linalg.norm(st[:, 3:7], axis=1, keepdims=True)
    return st.astype(np.float32), cases


def pyb_case_counts(st, params, obstacles):
    """How many envs of (n, 16, b) numpy states hold each case: a rim point
    within the contact window of the ground, a drone past the upright gate,
    a pair inside 2 * collision_r + slop, a drone stacked over another
    (within 5 cm horizontally), a drone in the contact window of an
    obstacle, and a pair at a downwash tie."""
    n = st.shape[0]
    rc, h2, slop = params.collision_r, params.collision_h / 2, 0.02
    p, q = st[:, 0:3], st[:, 3:7]
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    # lowest rim point: the body z axis tilts the bottom disk
    zz = 1 - 2 * (x * x + y * y)
    low = p[:, 2] - h2 * np.abs(zz) - rc * np.sqrt(np.maximum(1 - zz * zz, 0))
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
    out = {"ground": int((low < slop).any(axis=0).sum()),
           "tilted": int(((np.abs(roll) >= np.pi / 2)
                          | (np.abs(pitch) >= np.pi / 2)).any(axis=0).sum())}
    pair = stacked = tie = np.zeros(st.shape[2], bool)
    for i in range(n):
        for j in range(i + 1, n):
            d = p[i] - p[j]
            dxy = np.hypot(d[0], d[1])
            pair = pair | (np.linalg.norm(d, axis=0) < 2 * rc + slop)
            stacked = stacked | ((dxy < 0.05) & (np.abs(d[2]) > 0.1))
            tie = tie | (np.abs(d[2]) < DW_TIE_MARGIN)
    hit = np.zeros(st.shape[2], bool)
    for o in obstacles:
        rel = p - np.asarray(o[:3])[None, :, None]
        if len(o) == 4:
            gap = np.linalg.norm(rel, axis=1) - o[3] - rc
        else:
            half = np.asarray(o[3:])[None, :, None]
            gap = np.linalg.norm(rel - np.clip(rel, -half, half), axis=1) - rc
        hit = hit | (gap < slop).any(axis=0)
    out.update(pair=int(pair.sum()), stacked=int(stacked.sum()),
               obstacle=int(hit.sum()), downwash_tie=int(tie.sum()))
    return out


def render_ops_per_pixel(n_spheres, n_boxes, n_drones):
    """Float32 operations one pixel needs, counted from the plain version
    (`ops/render.py`), which finds, shades and keeps every primitive's hit:
    the function's work, whatever a kernel skips (each add, multiply,
    compare, select, sqrt, division and floor as one):
    the ray's offsets and direction 32, a sphere 57 (the quadratic 24, its
    roots and selects 9, the hit point and normal 15, the running minimum
    9), a box 79 (three slabs of 14, entry and exit 9, the normal 19, the
    running minimum 9), the plane 29, shading and depth 30.  Every pixel
    tests every primitive, so the count does not depend on the data."""
    return 91 + 57 * (n_spheres + n_drones) + 79 * n_boxes


def render_inputs(gen, c, n, dev):
    """(pos (c, 3), quat (c, 4)) of c cameras on `dev`: c // n envs of n
    drones within some 0.3 m of a centre over the arena, rolled a little,
    pitched from level to steeply down, any yaw; the first quarter of the
    envs over negative x and y, pitched down 0.5-1.3 rad."""
    from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops
    b = c // n
    centre = gen.uniform([-1.5, -1.5, 0.1], [1.5, 1.5, 1.2], (b, 1, 3))
    q = b // 4
    centre[:q, :, :2] = gen.uniform(-1.5, -0.2, (q, 1, 2))
    pos = (centre + gen.normal(0, 0.3, (b, n, 3))).reshape(c, 3)
    pos[:, 2] = np.abs(pos[:, 2]) + 0.02
    rpy = np.stack([gen.normal(0, 0.2, c), gen.uniform(-0.4, 1.2, c),
                    gen.uniform(-np.pi, np.pi, c)], -1)
    rpy[:q * n, 1] = gen.uniform(0.5, 1.3, q * n)
    quat = quat_ops.rpy_to_quat(torch.from_numpy(rpy.astype(np.float32)))
    return (torch.from_numpy(pos.astype(np.float32)).to(dev),
            quat.to(dev).contiguous())


def ptxas_figures(log):
    """Registers, stack frame and spills of the one __global__ function of
    a source, from the `-Xptxas -v` output of its build."""
    m = re.search(r"Function properties for \S*_kernel\S*\s+(\d+) bytes "
                  r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                  r"loads\s+ptxas info\s*: Used (\d+) registers", log)
    if m is None:      # a format this parser does not know: the raw lines
        return {"ptxas_lines": [line.strip() for line in log.splitlines()
                                if "registers" in line or "stack" in line]}
    stack, stores, loads, regs = (int(x) for x in m.groups())
    return {"registers": regs, "stack_frame_bytes": stack,
            "spill_store_bytes": stores, "spill_load_bytes": loads}


def occupancy(kernel, geometry, pyb):
    """Blocks of `kernel`'s launch of `geometry` (blocks, threads) that one
    SM of the card holds at once (the CUDA runtime's occupancy for the
    kernel as built, with its launcher's shared memory; `pyb`: the PYB
    family), and the launch's waves: its blocks over those of all SMs."""
    from gym_pybullet_drones_tpu_torch import _build
    blocks, threads = geometry
    per_sm = _build.resident_blocks(kernel, threads // 32, pyb)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"resident_blocks_per_sm": per_sm,
            "waves": blocks / (per_sm * sms)}


def eager_ms(fn, reps, warmup=3):
    """Per-call time of `fn` between two CUDA events (host enqueue
    included when the card outruns the host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, per_graph=50, replays=20):
    """Per-launch DEVICE time of `fn`: `per_graph` calls captured into one
    CUDA graph and replayed, so no host enqueue sits between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return eager_ms(graph.replay, replays) / per_graph


def check_close(name, got, ref, cols=None, tol=(ATOL, RTOL)):
    """Max abs error of `got` against `ref`; raises beyond `tol` = (atol,
    rtol), each a number or a per-row (rows, 1) tensor."""
    atol, rtol = tol
    if cols is not None:
        got, ref = got[:, cols], ref[:, cols]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values beyond atol/rtol "
            f"{tuple(float(torch.as_tensor(x).max()) for x in tol)}, "
            f"max abs err {float(err.max())}, worst row "
            f"{int((err - rtol * ref.abs()).max(dim=1).values.argmax())}")
    return float(err.max())


def row_tols(rows, spans):
    """Per-row (atol, rtol) column vectors: `spans` lists (first row, one
    past the last row, (atol, rtol)); other rows get ATOL, RTOL."""
    atol = torch.full((rows, 1), ATOL, device="cuda")
    rtol = torch.full((rows, 1), RTOL, device="cuda")
    for lo, hi, (a, r) in spans:
        atol[lo:hi], rtol[lo:hi] = a, r
    return atol, rtol


def dw_tie(pos):
    """(n, 3, b) positions -> (b,) bool: some pair of the env's drones
    within DW_TIE_MARGIN of one height."""
    tie = torch.zeros(pos.shape[2], dtype=torch.bool, device=pos.device)
    for i in range(pos.shape[0]):
        for j in range(i + 1, pos.shape[0]):
            tie |= (pos[i, 2] - pos[j, 2]).abs() < DW_TIE_MARGIN
    return tie


def fused_row_tols(spec):
    """(carry, outs) tolerances of `fused_env_step` against its plain
    version: (ATOL, RTOL), or per-row (atol, rtol) under PYB physics or
    PID-family actions (the embedded-PID and the contact rows' own)."""
    from gym_pybullet_drones_tpu_torch.ops.kernel_fused import PID_FAMILY
    from gym_pybullet_drones_tpu_torch.utils.enums import Physics
    n, per = spec.n, (spec.carry_rows - 1) // spec.n
    has_pid = spec.task.act in PID_FAMILY
    pyb = spec.cfg.physics != Physics.DYN
    if not (has_pid or pyb):
        return (ATOL, RTOL), (ATOL, RTOL)
    wide = lambda x, y: tuple(max(u, v) for u, v in zip(x, y))
    st_tol = PID_STATE_TOL if has_pid else (ATOL, RTOL)
    ob_tol = PID_OBS_TOL if has_pid else (ATOL, RTOL)
    angv = PYB_ANGV_TOL if pyb else (ATOL, RTOL)
    vel = PYB_VEL_TOL if pyb else (ATOL, RTOL)
    spans, ospans = [(0, spec.out_rows, ob_tol)], []
    for d in range(n):
        spans += [(d * per, d * per + 16, st_tol),
                  (d * per + 7, d * per + 10, wide(vel, st_tol)),
                  (d * per + 13, d * per + 16, wide(angv, st_tol))]
        if has_pid:
            spans += [(d * per + 16, d * per + 20, PID_RPM_TOL),
                      (d * per + 20, d * per + 29, PID_ROWS_TOL)]
        ob = d * spec.obs_rows_per
        ospans += [(ob + 6, ob + 9, wide(vel, ob_tol)),
                   (ob + 9, ob + 12, wide(angv, ob_tol))]
    return (row_tols(spec.carry_rows, spans[1:]),
            row_tols(spec.out_rows, spans[:1] + ospans))


def rand_state_rows(rng, b):
    """(16, b) float32 state rows around a hover, from numpy."""
    pos = rng.normal(size=(3, b)) * 0.3 + np.array([[0.0], [0.0], [1.0]])
    quat = rng.normal(size=(4, b)) * 0.1 + np.array([[0.0]] * 3 + [[1.0]])
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    vel = rng.normal(size=(3, b)) * 0.3
    rates = rng.normal(size=(3, b))
    ang_v = rng.normal(size=(3, b))
    return np.concatenate([pos, quat, vel, rates, ang_v]).astype(np.float32)


# ---- the sharded phase: each rank its own process (spawned), so these
# run at module level, where a rank finds them ----
SHARDED_RANKS = 2
SHARDED_CKPT = "build/chip_smoke/sharded_ckpt.pt"


def sharded_matrix():
    """The JAX package's multi-chip kernel matrix (`__graft_entry__.py`
    `_kernel_matrix`), each at a width this slice trains at: name ->
    (cfg, task, PPOConfig, env path, the path's kernel)."""
    from gym_pybullet_drones_tpu_torch import params as P
    from gym_pybullet_drones_tpu_torch.envs import (
        AviaryConfig, HoverTask, MultiHoverTask, make_routing_config)
    from gym_pybullet_drones_tpu_torch.rl import PPOConfig
    from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics
    multi = AviaryConfig(P.CF2X, 2, Physics.PYB_GND_DRAG_DW, 240, 30,
                         init_xyzs=((0.0, 0.0, 0.15), (0.3, 0.0, 0.6)))
    routing_cfg, routing_task = make_routing_config(num_drones=2,
                                                    spacing=0.4)
    return {
        # ppo_hover8192's configuration: 4096 envs a rank, K2 branch (a)
        "hover-dyn-rpm": (
            AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30),
            HoverTask(act=ActionType.RPM),
            PPOConfig(num_envs=8192, rollout_steps=64, num_minibatches=4,
                      update_epochs=4), "fused", "fused_env_step"),
        # drone-coupled contact and aero, on the batched path: K5
        "multihover-pyb-gnd-drag-dw": (
            multi, MultiHoverTask(act=ActionType.RPM),
            PPOConfig(num_envs=2048, rollout_steps=32, num_minibatches=4,
                      update_epochs=2), "batched", "env_ctrl_step"),
        # the routing fleet's PID waypoints in K2 (PYB, branch (c)+(d))
        "routing-pid": (
            routing_cfg, routing_task,
            PPOConfig(num_envs=2048, rollout_steps=32, num_minibatches=4,
                      update_epochs=2), "fused", "fused_env_step"),
    }


def launch_counts():
    """Each kernel wrapper's launch count in this process."""
    from gym_pybullet_drones_tpu_torch.ops import (
        kernel_dyn, kernel_env, kernel_fused, kernel_pid, kernel_render)
    return {"dyn_ctrl_step": kernel_dyn.launches,
            "pid_dyn_ctrl_step": kernel_pid.launches,
            "env_ctrl_step": kernel_env.launches,
            "fused_env_step": kernel_fused.launches,
            "render": kernel_render.launches}


def reset_counts():
    from gym_pybullet_drones_tpu_torch.ops import (
        kernel_dyn, kernel_env, kernel_fused, kernel_pid, kernel_render)
    kernel_dyn.launches = kernel_fused.launches = kernel_env.launches = 0
    kernel_pid.launches = kernel_render.launches = 0


def rank_kernel_check(cfg, task, env_state, kernel, gen):
    """This rank's launch of its path's kernel on its env state (after an
    update), held against the plain version on the same inputs, at the
    rank-local shape: (max abs err, envs left out at a downwash tie)."""
    from gym_pybullet_drones_tpu_torch.envs import fused_spec
    from gym_pybullet_drones_tpu_torch.ops import kernel_env, kernel_fused
    dev = env_state.pos.device if kernel == "env_ctrl_step" \
        else env_state.device
    if kernel == "fused_env_step":
        spec = fused_spec(cfg, task)
        b = env_state.shape[1]
        act = 0.3 * torch.randn((spec.n * spec.act_dim, b), device=dev,
                                generator=gen)
        (gc, go), (rc, ro) = (
            kernel_fused.fused_env_step(spec, env_state, act),
            kernel_fused.fused_env_step_plain(spec, env_state, act))
        torch.cuda.synchronize()
        if not torch.equal(go[-2:], ro[-2:]):
            raise AssertionError("sharded: the rank's fused_env_step flags "
                                 "differ from the plain version's")
        tol_c, tol_o = fused_row_tols(spec)
        return max(check_close("sharded fused_env_step carry", gc, rc,
                               tol=tol_c),
                   check_close("sharded fused_env_step outs", go, ro,
                               tol=tol_o)), 0
    # env_ctrl_step without PID: the flat EnvState as (k, B*N) rows
    n = cfg.num_drones
    flat = env_state
    s = torch.cat([flat.pos, flat.quat, flat.vel, flat.rpy_rates,
                   flat.ang_v], dim=-1).t().contiguous()
    rpm = (cfg.drone.hover_rpm * (1 + 0.05 * torch.randn(
        (4, s.shape[1]), device=dev, generator=gen))).contiguous()
    args = (None, cfg.drone, cfg.physics, n, cfg.steps_per_ctrl, cfg.pyb_dt,
            cfg.ctrl_dt, cfg.obstacles, s, rpm, None,
            flat.last_rpm.t().contiguous(), True, cfg.solver_iterations)
    got = kernel_env.env_ctrl_step_rows(*args)
    ref = kernel_env.env_ctrl_step_plain(*args)
    torch.cuda.synchronize()
    wide = lambda tol: tuple(max(x, y) for x, y in zip(tol, (ATOL, RTOL)))
    vel, angv = wide(PYB_VEL_TOL), wide(PYB_ANGV_TOL)
    tols = [row_tols(16, [(7, 10, vel), (13, 16, angv)]), (0.0, 0.0), None,
            row_tols(12, [(6, 9, vel), (9, 12, angv)])]
    # an env at a downwash tie is left out, and counted, if and only if
    # the two versions differ there
    tie = dw_tie(s[0:3].reshape(3, -1, n).permute(2, 0, 1))
    beyond = torch.zeros_like(tie)
    for g, r, tol in zip(got, ref, tols):
        if g is not None:
            atol, rtol = tol
            beyond |= (~((g - r).abs() <= atol + rtol * r.abs())).any(
                dim=0).reshape(-1, n).any(dim=1)
    tied = tie & beyond
    keep = (~tied).repeat_interleave(n)
    err = max(check_close(f"sharded env_ctrl_step {what}", g, r, keep, tol)
              for what, g, r, tol in zip(("state", "rpm", "pid", "obs12"),
                                         got, ref, tols) if g is not None)
    return err, int(tied.sum())


def sharded_rank(mesh, names, seed):
    """One rank of the sharded phase: for each matrix entry one sharded
    update from `init(seed)` (the path's launches counted from 0), this
    rank's kernel check, the state gathered; then the K = 4 population
    over the ranks and a sharded checkpoint.  Returns numpy and numbers
    only."""
    from gym_pybullet_drones_tpu_torch.envs import HoverTask
    from gym_pybullet_drones_tpu_torch.envs.core import leaves
    from gym_pybullet_drones_tpu_torch.parallel import (
        gather_train_state, make_sharded_update)
    from gym_pybullet_drones_tpu_torch.rl import (
        PPOConfig, make_train, make_train_population)
    from gym_pybullet_drones_tpu_torch.rl.population import (
        make_sharded_population_update, shard_population)
    from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    from gym_pybullet_drones_tpu_torch.utils.enums import ActionType
    dev = mesh.device
    np_ = lambda x: x.detach().cpu().numpy()
    params = lambda net: {k: np_(v) for k, v in net.state_dict().items()}
    out = {"rank": mesh.rank, "device": str(dev), "matrix": {}}
    for name in names:
        cfg, task, pp, path, kernel = sharded_matrix()[name]
        init, update, _, _ = make_train(cfg, task, pp, mesh=mesh,
                                        env_path=path)
        update = make_sharded_update(update, mesh)
        ts = init(torch.Generator(dev).manual_seed(seed))
        torch.cuda.synchronize()
        reset_counts()
        before = mesh.collectives
        ts, m = update(ts)
        metrics = {k: float(v) for k, v in m.items()}
        counts = {k: v for k, v in launch_counts().items() if v}
        rec = {"env_path": update.env_path, "launches": counts,
               "collectives": mesh.collectives - before,
               "columns": mesh.env_range(pp.num_envs), "metrics": metrics}
        rec["kernel_max_abs_err"], rec["kernel_dw_ties"] = \
            rank_kernel_check(cfg, task, ts.env_state, kernel,
                              torch.Generator(dev).manual_seed(
                                  seed + 1 + mesh.rank))
        g = gather_train_state(ts, mesh)
        rec.update(params=params(ts.network), last_obs=np_(g.last_obs))
        if name == "hover-dyn-rpm":
            # a checkpoint saved at R ranks; the state it holds; then the
            # next update, and the same from the restored file
            save_checkpoint(SHARDED_CKPT, ts, mesh=mesh)
            rec["saved"] = {"last_obs": np_(g.last_obs),
                            "env": [np_(x) for x in leaves(g.env_state)]}
            a, am = update(ts)
            am = {k: float(v) for k, v in am.items()}
            b, bm = update(restore_checkpoint(
                SHARDED_CKPT, init(torch.Generator(dev).manual_seed(
                    seed + 1)), mesh))
            diff = max(float((x - y).abs().max()) for x, y in zip(
                list(a.network.state_dict().values()) + leaves(a.env_state)
                + [a.last_obs], list(b.network.state_dict().values())
                + leaves(b.env_state) + [b.last_obs]))
            if diff != 0.0 or am != {k: float(v) for k, v in bm.items()}:
                raise AssertionError(f"sharded checkpoint: the update "
                                     f"resumed at R = {mesh.size} differs "
                                     f"by {diff}")
            ga = gather_train_state(a, mesh)
            rec["resumed"] = {"metrics": am, "params": params(a.network),
                              "last_obs": np_(ga.last_obs)}
        out["matrix"][name] = rec
    # population_update_parity's configuration, K = 4 over the ranks
    task = HoverTask(act=ActionType.RPM, episode_len_sec=0.5)
    pp = PPOConfig(num_envs=64, rollout_steps=24, num_minibatches=2,
                   update_epochs=2)
    cfg = sharded_matrix()["hover-dyn-rpm"][0]
    pinit, pupdate, _, _ = make_train_population(cfg, task, pp, 4,
                                                 device=dev)
    pts = shard_population(pinit(torch.Generator(dev).manual_seed(seed)),
                           mesh)
    pupd = make_sharded_population_update(pupdate, mesh)
    torch.cuda.synchronize()
    reset_counts()
    before = mesh.collectives
    pts, pm = pupd(pts)
    out["population"] = {
        "members": mesh.env_range(4), "collectives": mesh.collectives - before,
        "launches": {k: v for k, v in launch_counts().items() if v},
        "metrics": {k: np_(v) for k, v in pm.items()},
        "params": params(pts.network), "last_obs": np_(pts.last_obs)}
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from gym_pybullet_drones_tpu_torch import _build, convert, params as P
    from gym_pybullet_drones_tpu_torch.envs import (
        AviaryConfig, HoverTask, MultiHoverTask, core, fused_spec,
        make_batched_step, make_fused_rollout, make_routing_config)
    from gym_pybullet_drones_tpu_torch.envs.core import leaves, map_leaves
    from gym_pybullet_drones_tpu_torch.envs.tasks import TASK_ROUTING
    from gym_pybullet_drones_tpu_torch.ops import (
        kernel_dyn, kernel_env, kernel_fused, kernel_math, kernel_pid,
        kernel_render, render, quat as quat_ops)
    from gym_pybullet_drones_tpu_torch.ops.render_check import (
        CHECKER_TIE, DEPTH_ATOL, RGBA_ATOL, TIE_SHARE, compare_render,
        obs_ties)
    from gym_pybullet_drones_tpu_torch.models import (
        ActorCriticCNN, PopulationActorCriticCNN)
    from gym_pybullet_drones_tpu_torch.ops.kernel_env import (
        DRAG_MODES, DW_MODES, GND_MODES)
    from gym_pybullet_drones_tpu_torch.ops.kernel_fused import PID_FAMILY
    from gym_pybullet_drones_tpu_torch.rl import (
        Draws, PPOConfig, make_arrival_rate, make_train,
        make_train_population, member_state)
    from gym_pybullet_drones_tpu_torch.utils.enums import (
        ActionType, ObservationType, Physics)

    dev = torch.device("cuda", 0)
    card = gpu_line()
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": shutil.which("nvcc")
          or _build.find_nvcc(), "triton": has_triton, "gpu": card})

    # ---- build ----
    _build.load()
    ptxas = {name: ptxas_figures(log)
             for name, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": round(_build.build_seconds, 3),
          "sources": sorted(src for src, _ in _build.KERNELS.values()),
          "ptxas": ptxas})

    def hover_cfg(n=1):
        return AviaryConfig(P.CF2X, n, Physics.DYN, 240, 30)
    DT, SUB, CTRL_DT = 1 / 240, 8, 1 / 30

    # ---- kernels against their plain versions, on the card ----
    rng = np.random.default_rng(SEED)
    checks, geometry_records, summary = [], [], {}

    # The launch floor: a one-element in-place add under the same 50-node
    # graph harness, the least time one dependent graph node takes on this
    # card.  A yardstick only; the port never runs it.
    one = torch.zeros(1, device=dev)
    launch_floor_ms = graph_ms(lambda: one.add_(1.0))

    def floors(make_run):
        """`one_warp_ms` (B = 32: one block of one warp: the launch, one
        memory round trip and one thread's chain) and `columns_ms` (B =
        4096, 16384, 65536: where columns start to cost) of the launches
        `make_run(b)` makes."""
        return {"one_warp_ms": graph_ms(make_run(32)),
                "columns_ms": {str(b): graph_ms(make_run(b))
                               for b in (4096, 16384, 65536)}}

    def dyn_inputs(gen, model, b):
        s = rand_state_rows(gen, b)
        s[10:13, :4] = 0.0                       # zero rates: keep branch
        rpm = model.hover_rpm * (1 + 0.02 * gen.normal(size=(4, b)))
        rpm[:, :4] = model.hover_rpm             # and no torque
        return (torch.from_numpy(s).to(dev),
                torch.from_numpy(rpm.astype(np.float32)).to(dev))

    def dyn_case(model, b, emit_obs12, timed=None, n_sub=SUB, gen=None):
        s, rpm = dyn_inputs(gen or rng, model, b)
        run = lambda: kernel_dyn.dyn_ctrl_step_rows(model, s, rpm, n_sub, DT,
                                                    emit_obs12)
        plain = lambda: kernel_dyn.dyn_ctrl_step_plain(model, s, rpm, n_sub,
                                                       DT, emit_obs12)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if emit_obs12:
            err = max(check_close("dyn_ctrl_step state", got[0], ref[0]),
                      check_close("dyn_ctrl_step obs12", got[1], ref[1]))
            got = got[0]
        else:
            err = check_close("dyn_ctrl_step state", got, ref)
        if not torch.equal(got[3:7, :4], s[3:7, :4]):
            raise AssertionError("keep branch: quaternion changed at zero "
                                 f"rates ({n_sub} substeps)")
        rec = {"kernel": "dyn_ctrl_step", "model": model.model.value, "B": b,
               "n_substeps": n_sub, "emit_obs12": emit_obs12,
               "max_abs_err": err,
               "geometry": _build.launch_geometry("dyn_ctrl_step", b)}
        if timed:
            # 13 state rows (no ang-vel) and 4 rpm rows in, 16 (+12) out
            rows = 13 + 4 + 16 + (12 if emit_obs12 else 0)
            bms, by = bound_ms(rows * 4 * b, ops_per_column(SUB) * b)
            rec.update(ms=graph_ms(run), eager_ms=eager_ms(run, 200),
                       plain_ms=eager_ms(plain, 5, 1), bound_ms=bms,
                       bound_by=by)
            summary[("dyn_ctrl_step", timed)] = rec
        checks.append(rec)

    for model in (P.CF2X, P.CF2P, P.RACE):
        for emit_obs12 in (False, True):
            dyn_case(model, 4096, emit_obs12,
                     timed="hover4096" if model is P.CF2X and emit_obs12
                     else None)
    dyn_case(P.CF2X, 2 * 8192, True, timed="multihover2x8192")

    def rand_pid_rows(b, gen=None):
        """(9, b) PID scratch: last rpy, position and attitude integrals."""
        return ((gen or rng).normal(size=(9, b)) * np.repeat(
            [0.05, 0.01, 0.1], 3)[:, None]).astype(np.float32)

    def pid_inputs(gen, b):
        s = torch.from_numpy(rand_state_rows(gen, b)).to(dev)
        pid = torch.from_numpy(rand_pid_rows(b, gen)).to(dev)
        tgt = np.zeros((12, b))
        tgt[0:3] = gen.normal(size=(3, b)) * 0.5 + [[0.0], [0.0], [1.0]]
        tgt[5] = gen.normal(size=b) * 0.5          # target yaw
        tgt[6:9] = gen.normal(size=(3, b)) * 0.2
        return s, pid, torch.from_numpy(tgt.astype(np.float32)).to(dev)

    def pid_case(pid_model, dyn_model, b, emit_obs12, timed=None, n_sub=SUB,
                 gen=None):
        s, pid, tgt = pid_inputs(gen or rng, b)
        args = (pid_model, dyn_model, s, pid, tgt, n_sub, DT, CTRL_DT,
                emit_obs12)
        run = lambda: kernel_pid.pid_dyn_ctrl_step_rows(*args)
        plain = lambda: kernel_pid.pid_dyn_ctrl_step_plain(*args)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        tols = (PID_STATE_TOL, PID_ROWS_TOL, PID_RPM_TOL, PID_STATE_TOL)
        errs = [check_close(f"pid_dyn_ctrl_step {what}", g, r, tol=tol)
                for what, g, r, tol in zip(
                    ("state", "pid rows", "rpm", "obs12"), got, ref, tols)]
        rec = {"kernel": "pid_dyn_ctrl_step",
               "pid_model": pid_model.model.value,
               "model": dyn_model.model.value, "B": b, "n_substeps": n_sub,
               "emit_obs12": emit_obs12,
               "max_abs_err": max(errs[:2] + errs[3:]),
               "max_abs_err_rpm": errs[2],
               "geometry": _build.launch_geometry("pid_dyn_ctrl_step", b)}
        if timed:
            # 13 state rows (no ang-vel), 9 PID and 12 setpoint rows in;
            # 16 + 9 + 4 (+ 12) out
            rows = 13 + 9 + 12 + 16 + 9 + 4 + (12 if emit_obs12 else 0)
            bms, by = bound_ms(rows * 4 * b,
                               ops_per_column(SUB, pid=True) * b)
            rec.update(ms=graph_ms(run), eager_ms=eager_ms(run, 200),
                       plain_ms=eager_ms(plain, 5, 1), bound_ms=bms,
                       bound_by=by)
            summary[("pid_dyn_ctrl_step", timed)] = rec
        checks.append(rec)

    for model in (P.CF2X, P.CF2P, P.RACE):
        for emit_obs12 in (False, True):
            pid_case(P.CF2X, model, 4096, emit_obs12)
    pid_case(P.CF2P, P.CF2P, 4096, True)             # the + PWM mixer
    pid_case(P.CF2X, P.CF2X, 4 * 4096, True, timed="routing4x4096")

    # Both DYN kernels at other substep counts: 1 (240 Hz control) and 5,
    # at the main path's widths, from a stream of their own (the later
    # checks keep their inputs), and their floors at 8 substeps.
    gen = np.random.default_rng(SEED + 3)
    for n_sub in (1, 5):
        for b in (4096, 4 * 4096):
            dyn_case(P.CF2X, b, True, n_sub=n_sub, gen=gen)
            pid_case(P.CF2X, P.CF2X, b, True, n_sub=n_sub, gen=gen)
        pid_case(P.CF2P, P.CF2P, 4096, True, n_sub=n_sub, gen=gen)

    def dyn_run(b):
        s, rpm = dyn_inputs(gen, P.CF2X, b)
        return lambda: kernel_dyn.dyn_ctrl_step_rows(P.CF2X, s, rpm, SUB, DT,
                                                     True)

    def pid_run(b):
        args = (P.CF2X, P.CF2X, *pid_inputs(gen, b), SUB, DT, CTRL_DT, True)
        return lambda: kernel_pid.pid_dyn_ctrl_step_rows(*args)

    dyn_floors, pid_floors = floors(dyn_run), floors(pid_run)
    # the PID tick's share of a one-warp launch
    pid_floors["tick_ms"] = (pid_floors["one_warp_ms"]
                             - dyn_floors["one_warp_ms"])

    def pyb_ops(cfg_physics, n, obstacles, sweeps=4, pid=False,
                euler_calls=1):
        return pyb_ops_per_env(
            SUB, n, cfg_physics in GND_MODES, cfg_physics in DRAG_MODES,
            cfg_physics in DW_MODES, sweeps,
            sum(len(o) == 4 for o in obstacles),
            sum(len(o) == 6 for o in obstacles), pid, euler_calls)

    def beyond_envs(triples, per_env):
        """(envs,) bool: some value of some (got, ref, (atol, rtol)) beyond
        its tolerance (NaN counts as beyond); `per_env` columns an env."""
        out = None
        for g, r, (atol, rtol) in triples:
            bad = (~((g - r).abs() <= atol + rtol * r.abs())).any(dim=0)
            out = bad if out is None else out | bad
        return out.reshape(-1, per_env).any(dim=1)

    def unsettled(kernel_off, triples64, per_env):
        """Of the envs `kernel_off` (the kernel beyond the float32 plain
        version), those where the plain version in float64 is beyond it as
        well: there the step is not settled in float32
        (`scripts/downwash_witness.py`), so no float32 version can be held
        to it.  `triples64`: (plain64, plain32, tol)."""
        return kernel_off & beyond_envs(
            [(g.float(), r, tol) for g, r, tol in triples64], per_env)

    def subset_launch(kernel, n, b, envs, per_env, got, run_cols):
        """Launch `kernel` again on `envs` envs spread evenly over the b of
        a checked launch, `run_cols(columns)` taking the inputs' columns of
        those envs (`per_env` columns each), and require its outputs to be
        the checked launch's at those columns bit for bit: an env's threads
        compute the same wherever its block lies.  Returns the record."""
        idx = torch.arange(envs, device=dev) * (b // envs)
        cols = (idx[:, None] * per_env
                + torch.arange(per_env, device=dev)).reshape(-1)
        for g, g2 in zip(got, run_cols(cols)):
            if g is not None and not torch.equal(
                    g[:, cols].view(torch.int32), g2.view(torch.int32)):
                raise AssertionError(
                    f"{kernel} n={n}: {envs} envs of a {b}-env launch do "
                    "not give its outputs bit for bit")
        return {"kernel": kernel, "n": n, "B": envs, "envs_of": b,
                "bitwise": True,
                "geometry": _build.launch_geometry(kernel, envs, n)}

    def env_case(physics, n, use_pid, emit_obs12, model, b, timed=None,
                 obstacles=(SPHERE, BOX), sweeps=4, geometry=False):
        """`env_ctrl_step` against its plain version from identical random
        input, one launch: b envs of n drones with the case shares of
        `pyb_case_states`.  A `geometry` case packs the drones, leaves out
        and counts the envs not settled in float32 (`unsettled`), launches
        again on GEOMETRY_SUBSET of the envs (`subset_launch`), and goes to
        the geometry records."""
        dw = physics in DW_MODES
        st, _ = pyb_case_states(rng, b, n, model, dw, packed=geometry,
                                deep=not geometry)
        counts = pyb_case_counts(st, model, obstacles)
        rows = lambda x: torch.from_numpy(np.ascontiguousarray(
            x.transpose(1, 2, 0).reshape(x.shape[1], b * n)
            .astype(np.float32))).to(dev)       # (n, k, b) -> (k, b*n)
        s = rows(st)
        last = torch.from_numpy((model.hover_rpm * (
            1 + 0.05 * rng.normal(size=(4, b * n)))).astype(np.float32)) \
            .to(dev)
        pid = None
        if use_pid:
            tgt = np.zeros((n, 12, b))
            tgt[:, 0:3] = st[:, 0:3] + rng.normal(size=(n, 3, b)) * 0.3
            tgt[:, 5] = rng.normal(size=(n, b)) * 0.5     # target yaw
            tgt[:, 6:9] = rng.normal(size=(n, 3, b)) * 0.2
            a = rows(tgt)
            pid = torch.from_numpy(np.concatenate(
                [rand_pid_rows(b) for _ in range(n)], axis=1)).to(dev)
        else:
            a = torch.from_numpy((model.hover_rpm * (
                1 + 0.05 * rng.normal(size=(4, b * n))))
                .astype(np.float32)).to(dev)
        args = (P.CF2X if use_pid else None, model, physics, n, SUB, DT,
                CTRL_DT, obstacles, s, a, pid, last, emit_obs12, sweeps)
        run = lambda: kernel_env.env_ctrl_step_rows(*args)
        plain = lambda: kernel_env.env_ctrl_step_plain(*args)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        pyb = physics != Physics.DYN
        st_tol = PID_STATE_TOL if use_pid else (ATOL, RTOL)
        wide = lambda tol: tuple(max(x, y) for x, y in zip(tol, st_tol)) \
            if pyb else st_tol
        angv, vel = wide(PYB_ANGV_TOL), wide(PYB_VEL_TOL)
        tols = {"state": row_tols(16, [(0, 16, st_tol), (7, 10, vel),
                                       (13, 16, angv)]),
                "rpm": PID_RPM_TOL if use_pid else (0.0, 0.0),
                "pid rows": PID_ROWS_TOL,
                "obs12": row_tols(12, [(0, 12, st_tol), (6, 9, vel),
                                       (9, 12, angv)])}
        named = [(k, g, r) for k, g, r in zip(tols, got, ref)
                 if g is not None]
        differs = beyond_envs([(g, r, tols[k]) for k, g, r in named], n)
        # an env at a downwash tie is left out, if and only if the two
        # versions do differ there (or overflow there)
        tied = torch.zeros(b, dtype=torch.bool, device=dev)
        if dw and n > 1:
            tied = dw_tie(torch.from_numpy(st[:, 0:3]).to(dev)) & differs
        n_unsettled = 0
        if geometry and (differs & ~tied).any():
            ref64 = kernel_env.env_ctrl_step_plain(*args[:8], *(
                None if x is None else x.double() for x in args[8:12]),
                *args[12:])
            off = unsettled(differs & ~tied, [
                (g64, r, tols[k]) for (k, _, r), g64 in zip(
                    named, [x for x in ref64 if x is not None])], n)
            n_unsettled = int(off.sum())
            tied |= off
        same = (~tied).repeat_interleave(n)
        errs = {k: check_close(f"env_ctrl_step {physics.value} n={n} {k}",
                               g, r, same, tols[k]) for k, g, r in named}
        rec = {"kernel": "env_ctrl_step", "physics": physics.value, "n": n,
               "pid": use_pid, "emit_obs12": emit_obs12,
               "model": model.model.value, "B": b, "sweeps": sweeps,
               "max_abs_err": max(v for k, v in errs.items() if k != "rpm"),
               "max_abs_err_rpm": errs["rpm"],
               "envs_by_case": counts,
               "left_out_at_a_tie": int(tied.sum()) - n_unsettled,
               "geometry": _build.launch_geometry("env_ctrl_step", b, n)}
        rec.update(occupancy("env_ctrl_step", rec["geometry"], pyb))
        if geometry:
            rec["left_out_unsettled"] = n_unsettled
        if timed:
            # in: 16 state rows per drone (under DYN 13: the ang-vel rows
            # are recomputed), the action rows, the PID rows, the last rpm
            # in the drag modes; out: state, rpm, PID rows, obs12
            rows_moved = n * ((16 if pyb else 13)
                              + (12 + 9 if use_pid else 4)
                              + (4 if physics in DRAG_MODES else 0)
                              + 16 + 4 + (9 if use_pid else 0)
                              + (12 if emit_obs12 else 0))
            ops = pyb_ops(physics, n, obstacles, sweeps, use_pid,
                          int(emit_obs12)) if pyb else n * ops_per_column(
                              SUB, pid=use_pid, euler_calls=int(emit_obs12))
            bms, by = bound_ms(rows_moved * 4 * b, ops * b)
            rec.update(ms=graph_ms(run), eager_ms=eager_ms(run, 100),
                       plain_ms=eager_ms(plain, 2, 1), bound_ms=bms,
                       bound_by=by, rows_moved=rows_moved, ops_per_env=ops)
            summary[("env_ctrl_step", timed)] = rec
        if not geometry:
            checks.append(rec)
            return
        geometry_records.append(rec)
        geometry_records.append(subset_launch(
            "env_ctrl_step", n, b, GEOMETRY_SUBSET, n, got,
            lambda cols: kernel_env.env_ctrl_step_rows(*args[:8], *(
                None if x is None else x[:, cols] for x in args[8:12]),
                *args[12:])))

    for physics in (Physics.PYB, Physics.PYB_GND, Physics.PYB_DRAG,
                    Physics.PYB_DW, Physics.PYB_GND_DRAG_DW, Physics.DYN):
        for n in (1, 2, 4):
            for use_pid in (False, True):
                env_case(physics, n, use_pid, n != 2, P.CF2X, 1024)
    for model in (P.CF2P, P.RACE):
        for physics in (Physics.PYB, Physics.PYB_GND_DRAG_DW):
            env_case(physics, 2, False, True, model, 1024)
    env_case(Physics.PYB, 2, False, True, P.CF2X, 1024, sweeps=50)
    # the main path's shapes: the routing fleet (PYB, embedded PID) and the
    # hover under every aero effect, no obstacles in either
    env_case(Physics.PYB, 4, True, True, P.CF2X, 4096,
             timed="routing4x4096_pyb", obstacles=())
    env_case(Physics.PYB_GND_DRAG_DW, 1, False, True, P.CF2X, 4096,
             timed="hover4096_pyb_aero", obstacles=())

    def stepped_obs12(spec, carry, a_rows):
        """Per drone, the plain STEPPED (not reset) obs12 block of one
        fused step, from the kernels' plain versions."""
        cfg, task, n, A = spec.cfg, spec.task, spec.n, spec.act_dim
        per = (spec.carry_rows - 1) // n
        out = []
        if cfg.physics != Physics.DYN:
            # the coupled physics steps all drones of an env together
            states, rpms, lasts = [], [], []
            for d in range(n):
                st = list(carry[d * per:d * per + 16])
                a = a_rows[d * A:(d + 1) * A]
                if task.act in PID_FAMILY:
                    rpm, _ = kernel_pid.pid_tick_rows(
                        P.CF2X, CTRL_DT, st,
                        tuple(carry[d * per + 20:d * per + 29]),
                        kernel_fused.pid_setpoint_rows(cfg, task, st, a))
                else:
                    rpm = list((cfg.drone.hover_rpm * (1.0 + 0.05 * a))
                               .expand(4, -1))
                states.append(st)
                rpms.append(rpm)
                lasts.append(list(carry[d * per + 16:d * per + 20]))
            for f in kernel_env.pyb_ctrl_step_rows(
                    cfg.drone, cfg.physics, SUB, DT, cfg.obstacles, states,
                    rpms, lasts, cfg.solver_iterations):
                out.append(torch.stack(
                    tuple(f[0:3]) + kernel_math.quat_rpy_rows(*f[3:7])
                    + tuple(f[7:10]) + tuple(f[13:16])))
            return out
        for d in range(n):
            st = carry[d * per:d * per + 16].contiguous()
            a = a_rows[d * A:(d + 1) * A]
            if task.act in PID_FAMILY:
                tgt = torch.stack(kernel_fused.pid_setpoint_rows(
                    cfg, task, list(st[:13]), a))
                out.append(kernel_pid.pid_dyn_ctrl_step_plain(
                    P.CF2X, cfg.drone, st,
                    carry[d * per + 20:d * per + 29].contiguous(), tgt,
                    SUB, DT, CTRL_DT, True)[3])
            else:
                rpm = (cfg.drone.hover_rpm * (1.0 + 0.05 * a)).expand(4, -1)
                out.append(kernel_dyn.dyn_ctrl_step_plain(
                    cfg.drone, st, rpm.contiguous(), SUB, DT, True)[1])
        return out

    def pair_d2(pos):
        """(b, n, 3) positions -> (b, n, n) squared distances, +inf on the
        diagonal."""
        diff = pos[:, None, :, :] - pos[:, :, None, :]
        eye = torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
        return (diff * diff).sum(dim=-1).masked_fill(eye, float("inf"))

    def nn_tie(pos):
        """Per env: does some drone have two neighbours whose squared
        distances differ by less than NN_MARGIN (relative)?  There the
        nearest neighbour is decided by rounding."""
        if pos.shape[1] < 3:
            return torch.zeros(pos.shape[0], dtype=torch.bool,
                               device=pos.device)
        two = pair_d2(pos).topk(2, dim=-1, largest=False).values
        return ((two[..., 1] - two[..., 0])
                <= NN_MARGIN * two[..., 0]).any(dim=-1)

    def flag_margin(spec, stepped, sc_row):
        """Per env, how close the nearest deciding quantity of the task's
        flags (and, for routing, of the separation penalty) lies to its
        threshold, from the plain stepped obs12 blocks."""
        cfg, rc = spec.cfg, spec.task.row_consts(spec.cfg)
        margins, dist_sum = [], 0.0
        for o, tgt in zip(stepped, rc.targets):
            dist = torch.sqrt((tgt[0] - o[0]) ** 2 + (tgt[1] - o[1]) ** 2
                              + (tgt[2] - o[2]) ** 2)
            margins += [(o[3].abs() - rc.tilt).abs(),
                        (o[4].abs() - rc.tilt).abs()]
            if rc.task_id == TASK_ROUTING:
                margins.append((dist - rc.arrival_tol).abs())
            else:
                margins += [(o[0].abs() - rc.box_xy).abs(),
                            (o[1].abs() - rc.box_xy).abs(),
                            (o[2] - rc.box_z).abs()]
                dist_sum = dist_sum + dist
        if rc.task_id == TASK_ROUTING:
            pos = torch.stack([o[0:3] for o in stepped]).permute(2, 0, 1)
            margins.append((pair_d2(pos) - rc.collision_radius ** 2)
                           .abs().flatten(1).min(dim=1).values)
        else:
            margins.append((dist_sum - 1e-4).abs())
        margins.append((sc_row / cfg.pyb_freq - rc.episode_len_sec).abs())
        return torch.stack(margins).min(dim=0).values

    def fused_case(name, cfg, task, b, timed=True, geometry=False):
        """`fused_env_step` against its plain version from a random
        mid-episode carry, one launch; timed unless `timed` is False.  A
        `geometry` case is as in `env_case`."""
        spec = fused_spec(cfg, task)
        n, A = spec.n, spec.act_dim
        per = (spec.carry_rows - 1) // n
        has_pid = task.act in PID_FAMILY
        routing = task.row_consts(cfg).task_id == TASK_ROUTING
        # a mid-episode carry: random state, rpm, PID scratch and history;
        # counters up to past the episode's end, so that some envs truncate
        c = rng.normal(size=(spec.carry_rows, b)).astype(np.float32)
        pyb = cfg.physics != Physics.DYN
        dw = cfg.physics in DW_MODES
        counts = None
        if pyb:
            # the case shares of the PYB checks: ground, tilted, pair,
            # stacked, around the obstacles, free flight
            st16, _ = pyb_case_states(rng, b, n, cfg.drone, dw,
                                      packed=geometry, deep=not geometry)
        for d in range(n):
            c[d * per:d * per + 16] = st16[d] if pyb \
                else rand_state_rows(rng, b)
            c[d * per + 16:d * per + 20] = cfg.drone.hover_rpm * (
                1 + 0.02 * rng.normal(size=(4, b)))
            if has_pid:
                c[d * per + 20:d * per + 29] = rand_pid_rows(b)
        if routing:
            # a quarter of the envs has every drone slow and within a few
            # centimetres of its destination (arrivals, some envs
            # terminate); another quarter has drone 1 within a decimetre
            # of drone 0 (separation penalty).  Under PYB they are the last
            # two eighths, behind the contact cases.
            q = b // 8 if pyb else b // 4
            arr = slice(6 * q, 7 * q) if pyb else slice(0, q)
            close = slice(7 * q, 8 * q) if pyb else slice(q, 2 * q)
            for d, dest in enumerate(task.destinations):
                c[d * per:d * per + 3, arr] = np.asarray(dest)[:, None] \
                    + 0.02 * rng.normal(size=(3, q))
                c[d * per + 7:d * per + 10, arr] *= 0.05
            c[per:per + 3, close] = c[0:3, close] \
                + 0.06 * rng.normal(size=(3, q))
        if pyb:
            counts = pyb_case_counts(
                np.stack([c[d * per:d * per + 16] for d in range(n)]),
                cfg.drone, cfg.obstacles)
        last = int(task.episode_len_sec * cfg.ctrl_freq) + 6
        c[-1] = float(SUB) * rng.integers(0, last, size=b)
        carry = torch.from_numpy(c).to(dev)
        act = torch.from_numpy(
            (0.3 * rng.normal(size=(n * A, b))).astype(np.float32)).to(dev)
        run = lambda: kernel_fused.fused_env_step(spec, carry, act)
        plain = lambda: kernel_fused.fused_env_step_plain(spec, carry, act)
        (gc, go), (rc_, ro) = run(), plain()
        torch.cuda.synchronize()
        ro_base = n * spec.obs_rows_per
        flags_differ = (go[-2:] != ro[-2:]).any(dim=0)
        stepped = stepped_obs12(spec, carry, act)
        margin = flag_margin(spec, stepped, carry[-1])
        if (flags_differ & (margin > FLAG_MARGIN)).any():
            raise AssertionError(f"{name}: flags differ away from a tie")
        # envs whose reward or neighbour rows hang on a tie are left out
        # as well, if and only if the two versions do differ there
        tied = flags_differ.clone()
        if routing:
            sel = torch.stack([rc_[d * per:d * per + 3] for d in range(n)]) \
                .permute(2, 0, 1)                          # (b, n, 3)
            ext = torch.cat([torch.arange(
                d * spec.obs_rows_per + 15 + spec.buf_rows,
                (d + 1) * spec.obs_rows_per) for d in range(n)]).to(dev)
            beyond = lambda rows: (
                (go[rows] - ro[rows]).abs()
                > PID_OBS_TOL[0] + PID_OBS_TOL[1] * ro[rows].abs())
            tied |= nn_tie(sel) & beyond(ext).any(dim=0)
            tied |= (margin <= FLAG_MARGIN) & beyond(ro_base)
        tol_c, tol_o = fused_row_tols(spec)
        differs = beyond_envs([(gc, rc_, tol_c), (go, ro, tol_o)], 1)
        if dw and n > 1:
            # an env at a downwash tie is left out, if and only if the two
            # versions do differ there
            pos0 = torch.stack([carry[d * per:d * per + 3]
                                for d in range(n)])
            dw_tied = dw_tie(pos0) & differs
            n_dw_tied = int((dw_tied & ~tied).sum())
            tied |= dw_tied
        else:
            n_dw_tied = 0
        n_unsettled = 0
        if geometry and (differs & ~tied).any():
            rc64, ro64 = kernel_fused.fused_env_step_plain(
                spec, carry.double(), act.double())
            off = unsettled(differs & ~tied, [(rc64, rc_, tol_c),
                                              (ro64, ro, tol_o)], 1)
            n_unsettled = int(off.sum())
            tied |= off
        same = ~tied
        err_rpm = 0.0
        if has_pid:
            rpm_rows = torch.cat([torch.arange(d * per + 16, d * per + 20)
                                  for d in range(n)]).to(dev)
            err_rpm = float((gc[rpm_rows][:, same]
                             - rc_[rpm_rows][:, same]).abs().max())
            keep = torch.ones(spec.carry_rows, dtype=torch.bool, device=dev)
            keep[rpm_rows] = False
        else:
            keep = slice(None)
        check_close(f"{name} carry", gc, rc_, same, tol_c)
        err = max(float((gc[keep][:, same] - rc_[keep][:, same]).abs().max()),
                  check_close(f"{name} outs", go, ro, same, tol_o))
        done = (ro[-2:] > 0.5).any(dim=0)
        if not (done.any() and (~done).any()):
            raise AssertionError(f"{name}: the case must mix done and "
                                 "running envs")
        rec = {"kernel": "fused_env_step", "config": name, "B": b,
               "rows": [spec.carry_rows, spec.out_rows],
               "geometry": _build.launch_geometry("fused_env_step", b, n)}
        rec.update(occupancy("fused_env_step", rec["geometry"], pyb))
        if routing:
            d_goal = torch.stack([torch.sqrt(sum(
                (t[k] - o[k]) ** 2 for k in range(3)))
                for o, t in zip(stepped, task.destinations)])
            arrived = d_goal < task.arrival_tol
            close = (pair_d2(torch.stack([o[0:3] for o in stepped])
                             .permute(2, 0, 1))
                     < task.collision_radius ** 2).any(dim=-1).any(dim=-1)
            rec.update(envs_with_an_arrival=int(arrived.any(dim=0).sum()),
                       envs_terminated=int((ro[-2] > 0.5).sum()),
                       envs_with_a_close_pair=int(close.sum()))
            if not (arrived.any() and (ro[-2] > 0.5).any() and close.any()
                    and (~arrived).any()):
                raise AssertionError(f"{name}: the case must hold arrivals, "
                                     "terminations and close pairs")
        # in: per drone 13 state rows, the PID rows and the ring without the
        # A rows it drops (last_rpm and ang-vel are never read), the counter
        # row and the action rows; out: the whole carry and the outputs
        # (under PYB the 16 state rows, and last_rpm in the drag modes)
        rows = n * ((16 if pyb else 13)
                    + (4 if cfg.physics in DRAG_MODES else 0)
                    + (9 if has_pid else 0) + spec.buf_rows - A) + 1 \
            + n * A + spec.carry_rows + spec.out_rows
        ops = ops_per_column(SUB, n, euler_calls=2, pid=has_pid,
                             routing=routing)
        if pyb:
            ops += pyb_ops(cfg.physics, n, cfg.obstacles,
                           cfg.solver_iterations) \
                - n * (175 * SUB + 30 + 40 + 40)
        rec.update({
            "max_abs_err": err, "flag_ties": int(flags_differ.sum()),
            "other_ties": int(tied.sum() - flags_differ.sum()) - n_unsettled,
            "done_share": float(done.float().mean())})
        if geometry:
            rec["left_out_unsettled"] = n_unsettled
        if timed:
            bms, by = bound_ms(rows * 4 * b, ops * b)
            rec.update({
                "ms": graph_ms(run), "eager_ms": eager_ms(run, 200),
                "plain_ms": eager_ms(plain, 5, 1), "bound_ms": bms,
                "bound_by": by, "rows_moved": rows, "ops_per_env": ops})
            summary[("fused_env_step", name)] = rec
        if has_pid:
            rec["max_abs_err_rpm"] = err_rpm
        if pyb:
            rec.update(envs_by_case=counts, left_out_at_a_tie=n_dw_tied)
        if not geometry:
            checks.append(rec)
            return
        geometry_records.append(rec)
        geometry_records.append(subset_launch(
            "fused_env_step", n, b, GEOMETRY_SUBSET, 1, (gc, go),
            lambda cols: kernel_fused.fused_env_step(
                spec, carry[:, cols], act[:, cols])))

    fused_case("hover4096", hover_cfg(), HoverTask(act=ActionType.RPM), 4096)
    fused_case("hover4096_one_d_rpm", hover_cfg(),
               HoverTask(act=ActionType.ONE_D_RPM), 4096)
    fused_case("multihover2x8192", hover_cfg(2),
               MultiHoverTask(act=ActionType.RPM), 8192)
    rcfg, rtask = make_routing_config(num_drones=4, physics=Physics.DYN)
    fused_case("routing4x4096", rcfg, rtask, 4096)
    for act in (ActionType.ONE_D_PID, ActionType.VEL, ActionType.PID):
        fused_case(f"hover4096_{act.value}", hover_cfg(), HoverTask(act=act),
                   4096)
    # branch (d), the PYB family: the two main-path shapes, and a stacked
    # pair under every aero effect with both obstacles
    pcfg, ptask = make_routing_config(num_drones=4)
    fused_case("routing4x4096_pyb", pcfg, ptask, 4096)
    # the benchmark's routing cell: 16384 fleets, 512 blocks of 4 warps
    fused_case("routing4x16384_pyb", pcfg, ptask, 16384)
    acfg = AviaryConfig(P.CF2X, 1, Physics.PYB_GND_DRAG_DW, 240, 30)
    atask = HoverTask(act=ActionType.RPM)
    fused_case("hover4096_pyb_aero", acfg, atask, 4096)
    fused_case("multihover2x1024_pyb_aero_stacked", AviaryConfig(
        P.CF2X, 2, Physics.PYB_GND_DRAG_DW, 240, 30,
        init_xyzs=((0.0, 0.0, 0.3), (0.02, 0.0, 0.8)),
        obstacles=(SPHERE, BOX)), MultiHoverTask(act=ActionType.RPM), 1024)

    # geometry: both block-coupled kernels at 1, 2, 3, 4 and 8 drones a
    # block and with a partial last block (1000 = 31 x 32 + 8 envs, 33 =
    # 32 + 1), under every aero effect (downwash, with stacked spawns) and
    # the drones packed (`pyb_case_states`), so that every warp of a block
    # has a drone in contact with another; then branch (c), routing, at 3
    # drones.  The 1000-env launches are held against the plain versions,
    # the 33-env ones (33 of those envs) against them bit for bit; none
    # goes into the kernel table.
    # its own stream: its inputs do not move when an earlier check changes
    rng = np.random.default_rng(SEED + 2)
    for n in (1, 2, 3, 4, 8):
        env_case(Physics.PYB_GND_DRAG_DW, n, n % 2 == 0, True, P.CF2X, 1000,
                 geometry=True)
        fused_case(f"multihover{n}x1000_pyb_aero_stacked", AviaryConfig(
            P.CF2X, n, Physics.PYB_GND_DRAG_DW, 240, 30,
            init_xyzs=tuple((0.02 * d, 0.0, 0.3 + 0.5 * d)
                            for d in range(n)),
            obstacles=(SPHERE, BOX)), MultiHoverTask(act=ActionType.RPM),
            1000, timed=False, geometry=True)
    r3cfg, r3task = make_routing_config(num_drones=3, physics=Physics.DYN)
    fused_case("routing3x1000", r3cfg, r3task, 1000, timed=False,
               geometry=True)
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "atol": ATOL, "rtol": RTOL,
          "launch_floor_ms": launch_floor_ms,
          "floors": {"dyn_ctrl_step": dyn_floors,
                     "pid_dyn_ctrl_step": pid_floors},
          "cases": checks, "geometry": geometry_records})

    # ---- the main path ----
    def resting_warps(rates, a):
        """Warps of 32 consecutive columns in which some column starts the
        step with body rates exactly 0 under one RPM action on all four
        motors: no torque moves it, so its rates stay 0 through every
        substep, the input on which `sqrtf` takes its slow path (the
        kernels raise it to 1e-20 first).  `rates` (3, cols), `a`
        (cols, 4) -> the count of such warps, on the card."""
        rest = (rates == 0).all(dim=0) & (a == a[:, :1]).all(dim=1)
        return rest.reshape(-1, 32).any(dim=1).sum()

    def random_rollout(name, cfg, task, b, steps, compare_steps=32,
                       scale=0.1):
        """`steps` control steps of scale*N(0,1) actions through the fused
        path, then the first `compare_steps` again through the batched
        path (`dyn_ctrl_step`, or `pid_dyn_ctrl_step` for the PID family).

        The RPM paths run free from the same start.  Under the embedded
        PID two free-running paths drift apart (the 30 Hz attitude loop
        amplifies the last bit of the setpoint arithmetic; the record's
        `free_running_obs_drift_by_step` shows by how much), so there the
        batched path takes each of its steps from the fused path's own
        state before that step, and a flag may differ only within
        FLAG_MARGIN of its threshold."""
        n, A = cfg.num_drones, task.action_dim(cfg)
        pyb = cfg.physics != Physics.DYN
        # re-anchored: the embedded PID, and the PYB family, whose contact
        # solve amplifies a last-bit difference just as the attitude loop
        has_pid = task.act in PID_FAMILY or pyb
        batched_kernel = kernel_env if pyb else (
            kernel_pid if task.act in PID_FAMILY else kernel_dyn)
        tol = PID_OBS_TOL if has_pid else (ATOL, RTOL)
        obs_dim = task.obs_dim(cfg)
        if pyb:
            # the world ang-vel columns of every drone's observation
            tol = tuple(torch.full((n * obs_dim,), t, device=dev)
                        for t in tol)
            for d in range(n):
                tol[0][d * obs_dim + 9:d * obs_dim + 12] = PYB_ANGV_TOL[0]
                tol[1][d * obs_dim + 9:d * obs_dim + 12] = PYB_ANGV_TOL[1]
        rc2 = (2 * cfg.drone.collision_r + 0.02) ** 2
        n_pair = torch.zeros((), device=dev)
        n_ground = torch.zeros((), device=dev)
        per = (fused_spec(cfg, task).carry_rows - 1) // n
        acts = torch.from_numpy(
            (scale * np.random.default_rng(SEED + 1).normal(
                size=(steps, b, n, A))).astype(np.float32)).to(dev)
        spec = fused_spec(cfg, task)
        reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
        carry, obs = reset_fn()
        before = kernel_fused.launches
        chk = torch.zeros((), device=dev)
        n_done = torch.zeros((), device=dev)
        kept, kept_carry = [], []
        # resting columns: the DYN kernels' RPM paths
        count_rest = not pyb and task.act == ActionType.RPM
        rest_fused = rest_batched = torch.zeros((), device=dev)
        for t in range(steps):
            if has_pid and t < compare_steps:
                kept_carry.append(carry)
            if count_rest:
                for d in range(n):
                    rest_fused = rest_fused + resting_warps(
                        carry[d * per + 10:d * per + 13], acts[t][:, d])
            carry, obs, reward, term, trunc = step_fn(carry, acts[t])
            chk = chk + obs.sum() + reward.sum()
            n_done = n_done + (term | trunc).sum()
            if t < compare_steps:
                kept.append((obs, reward, term, trunc))
            if pyb:
                # env-steps that end with a drone pair inside the contact
                # window, or a drone within it of the ground
                pos = torch.stack([carry[d * per:d * per + 3]
                                   for d in range(n)]).permute(2, 0, 1)
                if n > 1:
                    n_pair = n_pair + (pair_d2(pos) < rc2).any(dim=-1) \
                        .any(dim=-1).sum()
                n_ground = n_ground + (
                    pos[:, :, 2] < cfg.drone.collision_h / 2 + 0.02) \
                    .any(dim=-1).sum()
        torch.cuda.synchronize()
        if obs.shape != (b, n * obs_dim) or reward.shape != (b,):
            raise AssertionError(f"{name}: shapes {obs.shape} {reward.shape}")
        if not (torch.isfinite(chk) and torch.isfinite(carry).all()):
            raise AssertionError(f"{name}: non-finite outputs")
        if int(n_done) == 0:
            raise AssertionError(f"{name}: no env was reset")
        if kernel_fused.launches - before != steps:
            raise AssertionError(f"{name}: {kernel_fused.launches - before} "
                                 f"launches for {steps} steps")
        # (c) the same start and actions through make_batched_step
        b_reset, b_step = make_batched_step(cfg, task, b, obs_layout="flat",
                                            device=dev)
        state, _ = b_reset()
        before = batched_kernel.launches
        err, ties, flag_ties = 0.0, 0, 0
        routing = task.row_consts(cfg).task_id == TASK_ROUTING
        for t in range(compare_steps):
            if has_pid:
                state = convert.env_state_from_fused_carry(
                    kept_carry[t], n, task.act)
            if count_rest:
                rest_batched = rest_batched + resting_warps(
                    state.rpy_rates.t(), acts[t].reshape(b * n, A))
            state, bo, br, bte, btr = b_step(state, acts[t])
            fo, fr, fte, ftr = kept[t]
            differ = (bte != fte) | (btr != ftr)
            if differ.any():
                if not has_pid:
                    raise AssertionError(
                        f"{name}: flags differ between the fused and "
                        f"batched paths at step {t}")
                a_rows = acts[t].reshape(b, n * A).t().contiguous()
                margin = flag_margin(spec, stepped_obs12(
                    spec, kept_carry[t], a_rows), kept_carry[t][-1])
                if (differ & (margin > FLAG_MARGIN)).any():
                    raise AssertionError(
                        f"{name}: flags differ away from a tie between the "
                        f"fused and batched paths at step {t}")
                # a tied env resets on one path only: leave it out
                flag_ties += int(differ.sum())
                bo = torch.where(differ[:, None], fo, bo)
                br = torch.where(differ, fr, br)
            if routing:
                # where a nearest neighbour or a separation penalty hangs
                # on a tie and the paths do differ, take the fused value
                beyond = lambda x, y, tl=tol: (
                    (x - y).abs() > tl[0] + tl[1] * y.abs())
                pos = state.pos.reshape(b, n, 3)
                nn = nn_tie(pos)[:, None] & beyond(bo, fo)
                nn[:, [c for c in range(n * obs_dim)
                       if c % obs_dim < obs_dim - 3]] = False
                pen = ((pair_d2(pos) - task.collision_radius ** 2).abs()
                       .flatten(1).min(dim=1).values <= FLAG_MARGIN) \
                    & beyond(br, fr, PID_OBS_TOL)
                ties += int(nn.any(dim=1).sum() + pen.sum())
                bo, br = torch.where(nn, fo, bo), torch.where(pen, fr, br)
            err = max(err, check_close(f"{name} obs t={t}", bo, fo, tol=tol),
                      check_close(f"{name} reward t={t}", br[None],
                                  fr[None], tol=PID_OBS_TOL if has_pid
                                  else tol))
        if batched_kernel.launches - before != compare_steps:
            raise AssertionError(f"{name}: batched path launch count")
        out = {"steps": steps, "envs": b, "resets": int(n_done),
               "fused_vs_batched_steps": compare_steps,
               "fused_vs_batched_max_abs_err": err}
        if count_rest:
            # share of the launches' warps that hold a resting column
            out["resting_warp_share"] = {
                "fused_env_step": float(rest_fused) / (steps * n * b / 32),
                "dyn_ctrl_step": float(rest_batched)
                / (compare_steps * n * b / 32)}
        if has_pid:
            out["fused_vs_batched_flag_ties"] = flag_ties
            # for the record, held to no tolerance: the first 8 steps free
            # running from the reset, the drift that the re-anchoring avoids
            state, _ = b_reset()
            drift = []
            for t in range(8):
                state, bo, _, _, _ = b_step(state, acts[t])
                drift.append(float((bo - kept[t][0]).abs().max()))
            out["free_running_obs_drift_by_step"] = drift
        if routing:
            out["fused_vs_batched_ties"] = ties
        if pyb:
            out["env_steps_with_a_pair_in_contact"] = int(n_pair)
            out["env_steps_with_a_drone_on_the_ground"] = int(n_ground)
        return out

    # rollout_hover
    kernel_dyn.launches = kernel_fused.launches = 0
    cfg, task, b = hover_cfg(), HoverTask(act=ActionType.RPM), 4096
    reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
    carry, obs = reset_fn()
    zero = torch.zeros((b, 1, 4), device=dev)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)[:, None]
    symmetric = torch.ones((), dtype=torch.bool, device=dev)
    all_tr, any_tr, any_te = [], [], []
    rest = torch.zeros((), device=dev)
    for t in range(300):
        rest = rest + resting_warps(carry[10:13], zero[:, 0])
        carry, obs, reward, term, trunc = step_fn(carry, zero)
        symmetric &= (carry[0:2] == 0).all() & (carry[3:7] == ident).all() \
            & (reward == reward[0]).all() & (obs[:, 0:2] == 0).all()
        all_tr.append(trunc.all())
        any_tr.append(trunc.any())
        any_te.append(term.any())
    all_tr, any_tr, any_te = (torch.stack(x).cpu().tolist()
                              for x in (all_tr, any_tr, any_te))
    trunc_steps = [t + 1 for t, x in enumerate(any_tr) if x]
    if trunc_steps != [242] or not all_tr[241] or any(any_te):
        raise AssertionError(f"zero actions: truncation on steps "
                             f"{trunc_steps}, expected exactly [242]")
    if not bool(symmetric):
        raise AssertionError("zero actions: the hover lost its symmetry")
    if kernel_fused.launches != 300:
        raise AssertionError("zero actions: launch count")
    hover = {"phase": "rollout_hover", "zero_action_trunc_steps": trunc_steps,
             "bitwise_symmetric": True,
             "zero_action_resting_warp_share": float(rest) / (300 * b / 32)}
    hover.update(random_rollout("hover4096", cfg, task, b, 512))
    hover_counts = {"dyn_ctrl_step": kernel_dyn.launches,
                    "fused_env_step": kernel_fused.launches}
    hover["launches"] = hover_counts
    emit(hover)

    # rollout_multihover
    kernel_dyn.launches = kernel_fused.launches = 0
    mcfg, mtask, mb = hover_cfg(2), MultiHoverTask(act=ActionType.RPM), 8192
    multi = {"phase": "rollout_multihover"}
    multi.update(random_rollout("multihover2x8192", mcfg, mtask, mb, 128))
    multi_counts = {"dyn_ctrl_step": kernel_dyn.launches,
                    "fused_env_step": kernel_fused.launches}
    multi["launches"] = multi_counts
    emit(multi)
    # rollout_routing: the fleet of 4 on DYN physics, embedded DSL-PID
    kernel_dyn.launches = kernel_fused.launches = kernel_pid.launches = 0
    rb = 4096
    reset_fn, step_fn = make_fused_rollout(rcfg, rtask, rb, device=dev)
    carry, obs = reset_fn()
    zero = torch.zeros((rb, 4, 3), device=dev)
    all_tr, any_tr, any_te = [], [], []
    for t in range(500):
        # a zero action commands the drone's own position
        carry, obs, reward, term, trunc = step_fn(carry, zero)
        all_tr.append(trunc.all())
        any_tr.append(trunc.any())
        any_te.append(term.any())
    all_tr, any_tr, any_te = (torch.stack(x).cpu().tolist()
                              for x in (all_tr, any_tr, any_te))
    trunc_steps = [t + 1 for t, x in enumerate(any_tr) if x]
    # 16 s at 240 Hz is substep 3840; step 482 is the first that starts
    # with more (481 * 8 = 3848) on its counter
    if trunc_steps != [482] or not all_tr[481] or any(any_te):
        raise AssertionError(f"routing, zero actions: truncation on steps "
                             f"{trunc_steps}, expected exactly [482]")
    if not torch.isfinite(carry).all():
        raise AssertionError("routing, zero actions: non-finite carry")
    if kernel_fused.launches != 500:
        raise AssertionError("routing, zero actions: launch count")
    routing = {"phase": "rollout_routing",
               "zero_action_trunc_steps": trunc_steps}
    routing.update(random_rollout("routing4x4096", rcfg, rtask, rb, 512,
                                  scale=0.3))
    routing_counts = {"pid_dyn_ctrl_step": kernel_pid.launches,
                      "fused_env_step": kernel_fused.launches}
    routing["launches"] = routing_counts
    emit(routing)
    if kernel_dyn.launches != 0:
        raise AssertionError("routing went through dyn_ctrl_step")

    def zero_action_episode(name, cfg, task, b, steps, expect):
        """Zero actions through the fused path: which control steps
        truncate, no termination, a finite carry."""
        reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
        carry, _ = reset_fn()
        zero = torch.zeros((b, cfg.num_drones, task.action_dim(cfg)),
                           device=dev)
        before = kernel_fused.launches
        all_tr, any_tr, any_te = [], [], []
        for t in range(steps):
            carry, obs, reward, term, trunc = step_fn(carry, zero)
            all_tr.append(trunc.all())
            any_tr.append(trunc.any())
            any_te.append(term.any())
        all_tr, any_tr, any_te = (torch.stack(x).cpu().tolist()
                                  for x in (all_tr, any_tr, any_te))
        trunc_steps = [t + 1 for t, x in enumerate(any_tr) if x]
        if trunc_steps != expect or any(any_te) \
                or not all(all_tr[t - 1] for t in expect):
            raise AssertionError(f"{name}, zero actions: truncation on "
                                 f"steps {trunc_steps}, expected {expect}")
        if not torch.isfinite(carry).all():
            raise AssertionError(f"{name}, zero actions: non-finite carry")
        if kernel_fused.launches - before != steps:
            raise AssertionError(f"{name}, zero actions: launch count")
        return trunc_steps

    # rollout_routing_pyb: the routing fleet in its DEFAULT configuration,
    # PYB physics with ground and drone-drone contact, embedded DSL-PID
    reset_counts()
    if pcfg.physics != Physics.PYB or ptask.obs_dim(pcfg) != 63:
        raise AssertionError("the default routing configuration changed")
    routing_pyb = {"phase": "rollout_routing_pyb",
                   "zero_action_trunc_steps": zero_action_episode(
                       "routing_pyb", pcfg, ptask, rb, 500, [482])}
    routing_pyb.update(random_rollout("routing4x4096_pyb", pcfg, ptask, rb,
                                      512, scale=0.3))
    routing_pyb_counts = {"env_ctrl_step": kernel_env.launches,
                          "fused_env_step": kernel_fused.launches}
    routing_pyb["launches"] = routing_pyb_counts
    # the same at the benchmark's routing cell's size, with its traffic's
    # 0.1 N(0,1) waypoint actions: 16384 fleets, one wave of 512 blocks
    reset_counts()
    routing_pyb["routing4x16384_pyb"] = random_rollout(
        "routing4x16384_pyb", pcfg, ptask, 16384, 512)
    routing_pyb["routing4x16384_pyb"]["launches"] = {
        "env_ctrl_step": kernel_env.launches,
        "fused_env_step": kernel_fused.launches}
    # K2's row of the kernel table (K5 has no row at this size)
    cell_counts = {"fused_env_step": kernel_fused.launches}
    emit(routing_pyb)
    if kernel_dyn.launches or kernel_pid.launches:
        raise AssertionError("routing PYB went through a DYN kernel")

    # rollout_hover_pyb_aero: ground effect, stale drag, ground contact.
    # First a landing: half the hover rpm on all four motors (a quarter of
    # the thrust; the ground effect more than triples it at the ground, so
    # 5 % less would hover at 6 cm) sinks the drone from its spawn 0.1 m
    # over the ground onto it.  It must come to rest on its collision
    # cylinder, level, and every env must do bitwise the same.  The
    # sequential contact sweeps leave a drift of some 0.1 mm/s and a yaw
    # rate of 1e-3 rad/s, so symmetry is held to a margin, not bitwise.
    reset_counts()
    reset_fn, step_fn = make_fused_rollout(acfg, atask, b, device=dev)
    carry, obs = reset_fn()
    down = torch.full((b, 1, 4), -10.0, device=dev)
    for t in range(96):
        carry, obs, reward, term, trunc = step_fn(carry, down)
    same_everywhere = bool((carry == carry[:, :1]).all())
    rest = carry[:, 0].cpu().tolist()
    h2 = acfg.drone.collision_h / 2
    landing = {"steps": 96, "rest_pos": rest[0:3], "rest_quat": rest[3:7],
               "rest_vel": rest[7:10], "all_envs_bitwise_equal":
               same_everywhere}
    if not same_everywhere:
        raise AssertionError("landing: envs differ from one another")
    if not (h2 - 0.003 < rest[2] <= h2 + 1e-4 and abs(rest[9]) < 1e-4
            and max(abs(rest[0]), abs(rest[1])) < 1e-3
            and max(abs(rest[3]), abs(rest[4])) < 1e-3
            and float(carry[-1, 0]) == 96 * SUB):
        raise AssertionError(f"landing: {landing}; the cylinder's half "
                             f"height is {h2}")
    hover_aero = {"phase": "rollout_hover_pyb_aero", "landing": landing}
    hover_aero.update(random_rollout("hover4096_pyb_aero", acfg, atask, b,
                                     512))
    hover_aero_counts = {"env_ctrl_step": kernel_env.launches,
                         "fused_env_step": kernel_fused.launches}
    hover_aero["launches"] = hover_aero_counts
    emit(hover_aero)
    if kernel_dyn.launches or kernel_pid.launches:
        raise AssertionError("hover PYB went through a DYN kernel")
    for counts in (hover_counts, multi_counts, routing_counts,
                   routing_pyb_counts, cell_counts, hover_aero_counts):
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel was never launched: {counts}")

    # ---- PPO: the trainer's rollout steps through fused_env_step ----
    # its own random stream: no earlier check's inputs move
    rng = np.random.default_rng(SEED + 4)

    def metric_values(metrics):
        return {k: float(v) for k, v in metrics.items()}

    # ppo_update_parity: the same update on the card and on the CPU, from
    # the same weights and the same draws.  Hover, DYN, RPM; episodes of
    # 0.5 s truncate on the 16th control step, inside the 24-step rollout.
    ptask_ppo = HoverTask(act=ActionType.RPM, episode_len_sec=0.5)
    pp = PPOConfig(num_envs=256, rollout_steps=24, num_minibatches=2,
                   update_epochs=2)
    draws = Draws(
        torch.from_numpy(rng.normal(size=(24, 256, 4)).astype(np.float32)),
        torch.from_numpy(np.stack([rng.permutation(24) for _ in range(2)])))
    sides, weights = {}, None
    for where in ("cpu", dev):
        init, update, _, _ = make_train(cfg, ptask_ppo, pp, device=where)
        ts = init(torch.Generator(where).manual_seed(SEED))
        if weights is None:
            weights = {k: v.clone() for k, v in
                       ts.network.state_dict().items()}
        ts.network.load_state_dict(weights)
        reset_counts()
        ts, metrics = update(ts, Draws(*(x.to(where) for x in draws)))
        sides[torch.device(where).type] = (
            ts, metric_values(metrics), kernel_fused.launches,
            update.env_path)
    (cpu_ts, cpu_m, cpu_launches, _), (card_ts, card_m, card_launches,
                                       card_path) = sides["cpu"], \
        sides["cuda"]
    if card_launches != 24 or cpu_launches != 0 or card_path != "fused":
        raise AssertionError(f"ppo_update_parity: {card_launches} launches "
                             f"on the card, {cpu_launches} counted on the "
                             f"CPU, path {card_path}")
    param_err = max(
        float((v.cpu() - cpu_ts.network.state_dict()[k]).abs().max())
        for k, v in card_ts.network.state_dict().items())
    moved = max(float((v - weights[k]).abs().max())
                for k, v in cpu_ts.network.state_dict().items())
    metric_err = {k: abs(card_m[k] - cpu_m[k]) for k in cpu_m}
    obs_err = check_close("ppo_update_parity last_obs",
                          card_ts.last_obs, cpu_ts.last_obs.to(dev))
    if param_err > PPO_PARAM_ATOL or moved < 100 * PPO_PARAM_ATOL or any(
            metric_err[k] > PPO_METRIC_TOL[0]
            + PPO_METRIC_TOL[1] * abs(cpu_m[k]) for k in cpu_m):
        raise AssertionError(f"ppo_update_parity: weights {param_err} "
                             f"(moved {moved}), metrics {metric_err}")
    emit({"phase": "ppo_update_parity", "num_envs": 256, "rollout_steps": 24,
          "launches": card_launches, "param_max_abs_err": param_err,
          "param_atol": PPO_PARAM_ATOL, "weights_moved": moved,
          "metric_abs_err": metric_err, "metric_tol": PPO_METRIC_TOL,
          "last_obs_max_abs_err": obs_err, "metrics_card": card_m})

    def checked_updates(update, ts, name, n=2, k2_per_update=None):
        """`n` updates (two by default: the first captures the minibatch
        step's graph, the second replays it throughout), each one's
        metrics read back and finite, its K2 launches checked if
        `k2_per_update`: the state and each update's metrics."""
        runs = []
        for _ in range(n):
            before = kernel_fused.launches
            ts, metrics = update(ts)
            m = {k: v.tolist() for k, v in metrics.items()}
            if k2_per_update is not None \
                    and kernel_fused.launches - before != k2_per_update:
                raise AssertionError(f"{name}: K2 launches per update")
            if not np.isfinite(list(m.values())).all():
                raise AssertionError(f"{name}: metrics {m}")
            runs.append(m)
        return ts, runs

    # ppo_hover8192: the JAX package's PPO throughput configuration
    # (bench_all.py:117-121): DYN, RPM, 8192 envs x 64 steps, 4 minibatches,
    # 4 epochs, the 64x64 MLP
    reset_counts()
    pp = PPOConfig(num_envs=8192, rollout_steps=64, num_minibatches=4,
                   update_epochs=4)
    init, update, _, _ = make_train(cfg, task, pp, device=dev)
    if update.env_path != "fused":
        raise AssertionError(f"ppo_hover8192: env path {update.env_path}")
    ts, per_update = checked_updates(
        update, init(torch.Generator(dev).manual_seed(SEED)),
        "ppo_hover8192", k2_per_update=64)
    ppo_counts = {"fused_env_step": kernel_fused.launches}
    if kernel_dyn.launches or kernel_pid.launches or kernel_env.launches:
        raise AssertionError("ppo_hover8192 went through another kernel")
    emit({"phase": "ppo_hover8192", "env_path": "fused",
          "launches": ppo_counts, "updates": per_update})

    # ppo_hover_pyb_learn: examples/learn.py's configuration, PYB physics
    # (branch (d) of fused_env_step), ONE_D_RPM, 64 envs x 64 steps, 4
    # minibatches, 10 epochs; 10 updates, then one episodic evaluation
    # (8 s x 30 Hz + 2 = 242 control steps)
    reset_counts()
    lcfg = AviaryConfig(P.CF2X, 1, Physics.PYB, 240, 30)
    ltask = HoverTask(act=ActionType.ONE_D_RPM)
    pp = PPOConfig(num_envs=64, rollout_steps=64, num_minibatches=4,
                   update_epochs=10)
    init, update, evaluate, _ = make_train(lcfg, ltask, pp, device=dev)
    ts = init(torch.Generator(dev).manual_seed(SEED))
    rewards = []
    for _ in range(10):
        ts, metrics = update(ts)
        rewards.append(metrics["mean_reward"])
    rewards = torch.stack(rewards).cpu().tolist()
    mean_return = float(evaluate(ts.network, episodic=True).mean())
    learn_counts = {"fused_env_step": kernel_fused.launches}
    if update.env_path != "fused" or learn_counts["fused_env_step"] \
            != 10 * 64 + 242:
        raise AssertionError(f"ppo_hover_pyb_learn: {learn_counts} on "
                             f"{update.env_path}")
    if kernel_dyn.launches or kernel_pid.launches or kernel_env.launches:
        raise AssertionError("ppo_hover_pyb_learn went through another "
                             "kernel")
    if not (np.isfinite(mean_return) and np.isfinite(rewards).all()):
        raise AssertionError(f"ppo_hover_pyb_learn: return {mean_return}")
    emit({"phase": "ppo_hover_pyb_learn", "launches": learn_counts,
          "train_mean_reward": rewards, "eval_return": mean_return})
    # the kernel at the two trainers' shapes, against its plain version
    fused_case("ppo_hover8192", cfg, task, 8192)
    fused_case("ppo_hover_pyb_learn", lcfg, ltask, 64)
    ppo_checks = checks[-2:]
    emit({"phase": "ppo_kernel_checks", "cases": ppo_checks})

    # ---- population PPO (rl/population.py): K policies, one K2 launch a
    # control step for all of them ----
    # its own random stream: no earlier check's inputs move
    rng = np.random.default_rng(SEED + 10)
    # the batched products must be IEEE float32, as the CNN's convolutions
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 products are on")

    def state_err(a, b):
        return max(float((v - b[k].to(v.device)).abs().max())
                   for k, v in a.items())

    # population_update_parity: K = 4 members of 64 envs, 24 steps, 2
    # minibatches, 2 epochs (ppo_update_parity's task).  Each member on
    # the card against `make_train`'s update of its weights and draws on
    # the card, and the whole population on the card against the CPU.
    K4 = 4
    pp = PPOConfig(num_envs=64, rollout_steps=24, num_minibatches=2,
                   update_epochs=2)
    draws = Draws(
        torch.from_numpy(rng.normal(size=(K4, 24, 64, 4))
                         .astype(np.float32)),
        torch.from_numpy(np.stack([[rng.permutation(24) for _ in range(2)]
                                   for _ in range(K4)])))
    sides, weights = {}, None
    for where in ("cpu", dev):
        pinit, pupd, _, _ = make_train_population(cfg, ptask_ppo, pp, K4,
                                                  device=where)
        ts = pinit(torch.Generator(where).manual_seed(SEED))
        if weights is None:
            weights = {k: v.clone() for k, v in
                       ts.network.state_dict().items()}
        ts.network.load_state_dict(weights)
        singles = [member_state(ts, k) for k in range(K4)]
        reset_counts()
        ts, metrics = pupd(ts, Draws(*(x.to(where) for x in draws)))
        sides[torch.device(where).type] = (
            ts, {k: v.tolist() for k, v in metrics.items()},
            kernel_fused.launches, pupd.env_path)
    (cpu_ts, cpu_m, cpu_launches, _), (card_ts, card_m, card_launches,
                                       card_path) = sides["cpu"], \
        sides["cuda"]
    if card_launches != 24 or cpu_launches != 0 or card_path != "fused":
        raise AssertionError(f"population_update_parity: {card_launches} "
                             f"K2 launches on the card (one a control step "
                             f"for all {K4} members), {cpu_launches} "
                             f"counted on the CPU, path {card_path}")
    metric_close = lambda a, b, tol: abs(a - b) <= tol[0] + tol[1] * abs(b)
    pop_param_err = state_err(card_ts.network.state_dict(),
                              cpu_ts.network.state_dict())
    pop_metric_err = {k: max(abs(a - b) for a, b in zip(card_m[k], cpu_m[k]))
                      for k in cpu_m}
    pop_obs_err = check_close("population_update_parity last_obs",
                              card_ts.last_obs, cpu_ts.last_obs.to(dev))
    moved = state_err(cpu_ts.network.state_dict(), weights)
    if pop_param_err > PPO_PARAM_ATOL or moved < 100 * PPO_PARAM_ATOL \
            or not all(metric_close(a, b, PPO_METRIC_TOL) for k in cpu_m
                       for a, b in zip(card_m[k], cpu_m[k])):
        raise AssertionError(f"population_update_parity, card vs CPU: "
                             f"weights {pop_param_err} (moved {moved}), "
                             f"metrics {pop_metric_err}")
    member_param_err, member_metric_err = [], []
    for k in range(K4):
        one, m1 = pupd.single(singles[k], Draws(draws.noise[k].to(dev),
                                                draws.perms[k].to(dev)))
        member_param_err.append(state_err(
            card_ts.network.member(k).state_dict(),
            one.network.state_dict()))
        member_metric_err.append(max(abs(card_m[q][k] - float(v))
                                     for q, v in m1.items()))
        if member_param_err[-1] > PPO_PARAM_ATOL or not all(
                metric_close(card_m[q][k], float(v), PPO_METRIC_TOL)
                for q, v in m1.items()):
            raise AssertionError(f"population_update_parity, member {k} vs "
                                 f"its own update: weights "
                                 f"{member_param_err[-1]}, metrics "
                                 f"{member_metric_err[-1]}")
    emit({"phase": "population_update_parity", "num_policies": K4,
          "num_envs": 64, "rollout_steps": 24, "launches": card_launches,
          "param_atol": PPO_PARAM_ATOL, "metric_tol": PPO_METRIC_TOL,
          "card_vs_cpu_param_max_abs_err": pop_param_err,
          "card_vs_cpu_metric_max_abs_err": pop_metric_err,
          "card_vs_cpu_last_obs_max_abs_err": pop_obs_err,
          "member_vs_single_param_max_abs_err": member_param_err,
          "member_vs_single_metric_max_abs_err": member_metric_err,
          "weights_moved": moved, "matmul_tf32": False,
          "metrics_card": card_m})

    # ppo_population8x1024: the JAX package's population throughput
    # configuration (bench_all.py:142-181): Hover, DYN, RPM, 1024 envs a
    # policy x 64 steps, 4 minibatches, 4 epochs, the 64x64 MLP; K = 8,
    # and the single policy at 1024 envs
    pp = PPOConfig(num_envs=1024, rollout_steps=64, num_minibatches=4,
                   update_epochs=4)
    population_runs = {}
    for label, k in (("single1024", None), ("population8x1024", 8)):
        reset_counts()
        if k is None:
            init, update, _, _ = make_train(cfg, task, pp, device=dev)
        else:
            init, update, _, _ = make_train_population(cfg, task, pp, k,
                                                       device=dev)
        if update.env_path != "fused":
            raise AssertionError(f"{label}: env path {update.env_path}")
        ts, runs = checked_updates(
            update, init(torch.Generator(dev).manual_seed(SEED)), label,
            k2_per_update=64)
        if kernel_dyn.launches or kernel_pid.launches \
                or kernel_env.launches:
            raise AssertionError(f"{label} went through another kernel")
        population_runs[label] = {
            "num_policies": k or 1,
            "launches": {"fused_env_step": kernel_fused.launches},
            "updates": runs}
    pop_counts = population_runs["population8x1024"]["launches"]
    emit({"phase": "ppo_population8x1024", "env_path": "fused",
          "runs": population_runs})
    # the kernel at the population's shape, and at the MultiHover
    # population run's (examples/train_population.py: PYB, ONE_D_RPM, 2
    # drones, 8 x 128 envs; branch (d)), against its plain version
    fused_case("ppo_population8x1024", cfg, task, 8192)
    fused_case("multihover_population8x128",
               AviaryConfig(P.CF2X, 2, Physics.PYB, 240, 30),
               MultiHoverTask(act=ActionType.ONE_D_RPM), 1024)
    emit({"phase": "population_kernel_checks", "cases": checks[-2:]})

    # ppo_bf16_parity: one compute_dtype="bfloat16" update on the card
    # against the CPU from the same weights and draws (ppo_update_parity's
    # configuration), then bf16 updates at ppo_hover8192's configuration
    rng = np.random.default_rng(SEED + 11)
    bp = PPOConfig(num_envs=256, rollout_steps=24, num_minibatches=2,
                   update_epochs=2, compute_dtype="bfloat16")
    draws = Draws(
        torch.from_numpy(rng.normal(size=(24, 256, 4)).astype(np.float32)),
        torch.from_numpy(np.stack([rng.permutation(24) for _ in range(2)])))
    sides, weights = {}, None
    for where in ("cpu", dev):
        init, update, _, _ = make_train(cfg, ptask_ppo, bp, device=where)
        ts = init(torch.Generator(where).manual_seed(SEED))
        if ts.network.compute_dtype != torch.bfloat16:
            raise AssertionError("ppo_bf16_parity: not a bf16 network")
        if weights is None:
            weights = {k: v.clone() for k, v in
                       ts.network.state_dict().items()}
        ts.network.load_state_dict(weights)
        ts, metrics = update(ts, Draws(*(x.to(where) for x in draws)))
        sides[torch.device(where).type] = (ts, metric_values(metrics))
    (cpu_ts, cpu_m), (card_ts, card_m) = sides["cpu"], sides["cuda"]
    cpu_sd = cpu_ts.network.state_dict()
    offs = {k: (v.cpu() - cpu_sd[k]).abs()
            for k, v in card_ts.network.state_dict().items()}
    bf16_param_err = max(float(o.max()) for o in offs.values())
    bf16_far_share = max(float((o > BF16_PARAM_NEAR).float().mean())
                         for o in offs.values())
    bf16_metric_err = {k: abs(card_m[k] - cpu_m[k]) for k in cpu_m}
    bf16_obs_err = check_close("ppo_bf16_parity last_obs",
                               card_ts.last_obs, cpu_ts.last_obs.to(dev))
    if bf16_param_err > BF16_PARAM_ATOL or bf16_far_share > BF16_FAR_SHARE \
            or not all(metric_close(card_m[k], cpu_m[k], BF16_METRIC_TOL)
                       for k in cpu_m):
        raise AssertionError(f"ppo_bf16_parity: weights {bf16_param_err} "
                             f"(share beyond {BF16_PARAM_NEAR}: "
                             f"{bf16_far_share}), metrics {bf16_metric_err}")
    reset_counts()
    bp = dataclasses.replace(bp, num_envs=8192, rollout_steps=64,
                             num_minibatches=4, update_epochs=4)
    init, update, _, _ = make_train(cfg, task, bp, device=dev)
    ts, bf16_updates = checked_updates(
        update, init(torch.Generator(dev).manual_seed(SEED)),
        "ppo_hover8192 bf16", k2_per_update=64)
    emit({"phase": "ppo_bf16_parity", "num_envs": 256,
          "rollout_steps": 24, "param_max_abs_err": bf16_param_err,
          "param_atol": BF16_PARAM_ATOL,
          "param_share_beyond_near": bf16_far_share,
          "param_near": BF16_PARAM_NEAR, "far_share_max": BF16_FAR_SHARE,
          "metric_abs_err": bf16_metric_err, "metric_tol": BF16_METRIC_TOL,
          "last_obs_max_abs_err": bf16_obs_err, "metrics_card": card_m,
          "hover8192_bf16_updates": bf16_updates})

    # ---- RGB observations: the render kernel against its plain version ----
    # its own random stream: no earlier check's inputs move
    rng = np.random.default_rng(SEED + 5)
    render_checks = []

    def render_case(scene_name, n, c, width=64, height=48, timed=None):
        scene = getattr(render, f"{scene_name}_scene")()
        p, q = render_inputs(rng, c, n, dev)
        run = lambda ds=True: kernel_render.render_drones(
            P.CF2X, scene, p, q, n, width, height, depth_seg=ds)
        plain = lambda: kernel_render.render_drones_plain(
            P.CF2X, scene, p, q, n, width, height)
        got, ref = run(), plain()
        rec = {"kernel": "render", "scene": scene_name, "drones_per_env": n,
               "cameras": c, "width": width, "height": height,
               "geometry": _build.launch_geometry("render", c,
                                                  width * height)}
        name = f"render {scene_name} n={n} c={c} {width}x{height}"
        rec.update(compare_render(name, got, ref, p, render.camera_forward(q),
                                  P.CF2X.l))
        # built without FMA contraction, the kernel rounds every product
        # and sum as the plain version does: no tie may differ either
        if not rec["bitwise_equal"]:
            raise AssertionError(f"{name}: not bit for bit its plain "
                                 f"version ({rec['seg_differ']} seg, "
                                 f"{rec['checker_ties']} checker ties)")
        rec["ids"] = torch.unique(ref[2]).tolist()
        rec["max_abs_err"] = max(rec["rgba_max_abs_err"],
                                 rec["depth_max_abs_err"])
        if timed:
            # the obs path: rgba only, 16 bytes a pixel written, the
            # cameras' 7 floats read
            npix = c * width * height
            ops = render_ops_per_pixel(len(scene.sphere_radius),
                                       len(scene.box_id), n)
            bms, by = bound_ms(16 * npix + 28 * c, ops * npix)
            rec.update(ms=graph_ms(lambda: run(False)),
                       eager_ms=eager_ms(lambda: run(False), 200),
                       plain_ms=eager_ms(plain, 5, 1), bound_ms=bms,
                       bound_by=by, ops_per_pixel=ops)
            summary[("render", timed)] = rec
        render_checks.append(rec)

    for scene_name in ("landmark", "empty"):
        for n in (1, 2, 4):
            for c in (256, 512, 33 + (-33) % n):
                render_case(scene_name, n, c)
    render_case("landmark", 2, 64, width=40, height=30)  # a partial block
    render_case("landmark", 1, 256, timed="hover256_rgb")
    render_case("landmark", 1, 512, timed="ppo_rgb512")
    # a prime number of cameras, and more cameras than the grid's 65535
    # rows, so that the camera loop turns twice in the first blocks (a
    # small image: one partial block of pixels a camera, the plain version
    # cheap)
    render_case("landmark", 1, 37)
    render_case("landmark", 4, 65536 + 100, width=16, height=12)
    torch.cuda.synchronize()
    emit({"phase": "render_checks", "rgba_atol": RGBA_ATOL,
          "depth_atol": DEPTH_ATOL, "tie_share": TIE_SHARE,
          "checker_tie": CHECKER_TIE, "cases": render_checks})

    # hover256_rgb: the JAX package's RGB rollout configuration
    # (bench_all.py:103-113): Hover, DYN, RPM, RGB obs, 256 envs, 0.1 N(0, 1)
    # actions, through make_batched_step: dyn_ctrl_step (no obs12 rows) and
    # one render launch a control step, and one for the reset image, built
    # with the step.  The reset and 8 steps on the card against the same on
    # the CPU (the plain versions), the card's reset image also against the
    # plain version on the card.
    gcfg = hover_cfg()
    gtask = HoverTask(act=ActionType.RPM, obs=ObservationType.RGB)
    gb = 256
    gacts = torch.from_numpy((0.1 * np.random.default_rng(SEED + 6).normal(
        size=(8, gb, 1, 4))).astype(np.float32))
    sides = {}
    for where in ("cpu", dev):
        reset_counts()
        g_reset, g_step = make_batched_step(gcfg, gtask, gb,
                                            obs_layout="flat", device=where)
        reset_launches = kernel_render.launches
        state, obs = g_reset()
        reset_state = state
        out = [obs]
        for t in range(8):
            state, obs, reward, term, trunc = g_step(state,
                                                     gacts[t].to(where))
            out.append((obs, reward, term | trunc, state.pos))
        sides[torch.device(where).type] = out
    # the card's launches: one K1 and one render a step, one render for
    # the reset image
    rgb_counts = {"dyn_ctrl_step": kernel_dyn.launches,
                  "render": kernel_render.launches}
    if rgb_counts != {"dyn_ctrl_step": 8, "render": 8 + 1} \
            or kernel_fused.launches or kernel_pid.launches \
            or kernel_env.launches:
        raise AssertionError(f"hover256_rgb: launches {rgb_counts}")
    if obs.shape != (gb, 48 * 64 * 4) or not (
            (obs >= 0) & (obs <= 255)).all():
        raise AssertionError(f"hover256_rgb: obs {tuple(obs.shape)}")
    # the card's reset image came from one launch of the render kernel
    reset_plain = kernel_render.render_drones_plain(
        P.CF2X, render.landmark_scene(), reset_state.pos, reset_state.quat,
        1)[0]
    if reset_launches != 1:
        raise AssertionError(f"hover256_rgb: {reset_launches} render "
                             "launches for the reset image")
    reset_ties = obs_ties("hover256_rgb reset obs, kernel vs plain",
                          sides["cuda"][0], reset_plain)
    if not torch.equal(sides["cuda"][0].reshape(-1), reset_plain.reshape(-1)):
        raise AssertionError("hover256_rgb: the reset image is not bit for "
                             "bit its plain version")
    ties = obs_ties("hover256_rgb reset obs", sides["cuda"][0],
                    sides["cpu"][0].to(dev))
    rgb_err = 0.0
    for t in range(1, 9):
        (co, cr, cd, cp), (go, gr, gd, gp) = sides["cpu"][t], sides["cuda"][t]
        ties += obs_ties(f"hover256_rgb obs t={t}", go, co.to(dev))
        rgb_err = max(rgb_err,
                      check_close(f"hover256_rgb pos t={t}", gp.t(),
                                  cp.to(dev).t()),
                      check_close(f"hover256_rgb reward t={t}", gr[None],
                                  cr.to(dev)[None]))
        if not torch.equal(gd.cpu(), cd):
            raise AssertionError(f"hover256_rgb: flags differ at step {t}")
    dyn_case(P.CF2X, gb, False, timed="hover256_rgb",
             gen=np.random.default_rng(SEED + 7))
    emit({"phase": "hover256_rgb", "envs": gb, "launches": rgb_counts,
          "card_vs_cpu_steps": 8, "card_vs_cpu_max_abs_err": rgb_err,
          "card_vs_cpu_obs_ties": ties,
          "reset_obs_render_launches": reset_launches,
          "reset_obs_kernel_vs_plain_ties": reset_ties})

    # ppo_rgb_update_parity: one pixel-PPO update on the card against the
    # same update on the CPU, from the same weights and draws.  Hover, DYN,
    # ONE_D_RPM, RGB; 0.25 s episodes truncate on control step 9, inside
    # the 12-step rollout.  The images agree but for ties and the CPU's
    # vector square root (up to 0.008 of 255 on a pixel); tolerances as
    # ppo_update_parity's.
    rng = np.random.default_rng(SEED + 8)
    qtask = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB,
                      episode_len_sec=0.25)
    qp = PPOConfig(num_envs=16, rollout_steps=12, num_minibatches=2,
                   update_epochs=2)
    draws = Draws(
        torch.from_numpy(rng.normal(size=(12, 16, 1)).astype(np.float32)),
        torch.from_numpy(np.stack([rng.permutation(12) for _ in range(2)])))
    sides, weights = {}, None
    for where in ("cpu", dev):
        init, update, _, network = make_train(gcfg, qtask, qp, device=where)
        if not isinstance(network, ActorCriticCNN):
            raise AssertionError("ppo_rgb_update_parity: not the CNN")
        ts = init(torch.Generator(where).manual_seed(SEED))
        if weights is None:
            weights = {k: v.clone() for k, v in
                       ts.network.state_dict().items()}
        ts.network.load_state_dict(weights)
        reset_counts()
        ts, metrics = update(ts, Draws(*(x.to(where) for x in draws)))
        sides[torch.device(where).type] = (
            ts, metric_values(metrics),
            (kernel_dyn.launches, kernel_render.launches))
    (cpu_ts, cpu_m, cpu_n), (card_ts, card_m, card_n) = sides["cpu"], \
        sides["cuda"]
    if card_n != (12, 12) or cpu_n != (0, 0):
        raise AssertionError(f"ppo_rgb_update_parity: launches {card_n} on "
                             f"the card, {cpu_n} counted on the CPU")
    param_err = max(
        float((v.cpu() - cpu_ts.network.state_dict()[k]).abs().max())
        for k, v in card_ts.network.state_dict().items())
    moved = max(float((v - weights[k]).abs().max())
                for k, v in cpu_ts.network.state_dict().items())
    metric_err = {k: abs(card_m[k] - cpu_m[k]) for k in cpu_m}
    obs_tie_count = obs_ties("ppo_rgb_update_parity last_obs",
                             card_ts.last_obs, cpu_ts.last_obs.to(dev))
    if param_err > PPO_PARAM_ATOL or moved < 100 * PPO_PARAM_ATOL or any(
            metric_err[k] > PPO_METRIC_TOL[0]
            + PPO_METRIC_TOL[1] * abs(cpu_m[k]) for k in cpu_m):
        raise AssertionError(f"ppo_rgb_update_parity: weights {param_err} "
                             f"(moved {moved}), metrics {metric_err}")
    emit({"phase": "ppo_rgb_update_parity", "num_envs": 16,
          "rollout_steps": 12, "launches": {"dyn_ctrl_step": card_n[0],
                                            "render": card_n[1]},
          "param_max_abs_err": param_err, "param_atol": PPO_PARAM_ATOL,
          "weights_moved": moved, "metric_abs_err": metric_err,
          "metric_tol": PPO_METRIC_TOL, "last_obs_ties": obs_tie_count,
          "last_obs_max_abs_err": float(
              (card_ts.last_obs - cpu_ts.last_obs.to(dev)).abs().max()),
          "metrics_card": card_m, "conv_precision": "ieee float32"})

    # ppo_rgb512: the JAX package's pixel-PPO throughput configuration
    # (bench_all.py:184-208): Hover, DYN, ONE_D_RPM, RGB, 512 envs x 32
    # steps, 4 minibatches, 2 epochs, lr 1e-4, the NatureCNN
    reset_counts()
    zp = PPOConfig(num_envs=512, rollout_steps=32, num_minibatches=4,
                   update_epochs=2, lr=1e-4)
    ztask = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB)
    init, update, _, _ = make_train(gcfg, ztask, zp, device=dev)
    if update.env_path != "batched":
        raise AssertionError(f"ppo_rgb512: env path {update.env_path}")
    ts, rgb512_updates = checked_updates(
        update, init(torch.Generator(dev).manual_seed(SEED)), "ppo_rgb512")
    rgb512_counts = {"dyn_ctrl_step": kernel_dyn.launches,
                     "render": kernel_render.launches}
    # 2 updates of 32 steps, and the reset image built with the step
    if rgb512_counts != {"dyn_ctrl_step": 2 * 32, "render": 2 * 32 + 1} \
            or kernel_fused.launches or kernel_pid.launches \
            or kernel_env.launches:
        raise AssertionError(f"ppo_rgb512: launches {rgb512_counts}")
    emit({"phase": "ppo_rgb512", "env_path": "batched",
          "launches": rgb512_counts, "updates": rgb512_updates,
          "conv_precision": "ieee float32"})
    dyn_case(P.CF2X, 512, False, timed="ppo_rgb512",
             gen=np.random.default_rng(SEED + 9))

    # ---- a population of pixel policies (rl/population.py on RGB): one
    # PopulationActorCriticCNN, each trunk layer one grouped convolution
    # over the members; one K1 and one render launch a control step for
    # all K x E envs ----
    # population_rgb_update_parity: K = 2 members of ppo_rgb_update_parity's
    # configuration (16 envs x 12 steps, 2 minibatches, 2 epochs), the
    # population on the card against the CPU and each member on the card
    # against `make_train`'s update of its weights and draws on the card,
    # held as ppo_rgb_update_parity
    rng = np.random.default_rng(SEED + 12)
    KR = 2
    draws = Draws(
        torch.from_numpy(rng.normal(size=(KR, 12, 16, 1)).astype(np.float32)),
        torch.from_numpy(np.stack([[rng.permutation(12) for _ in range(2)]
                                   for _ in range(KR)])))
    sides, weights = {}, None
    for where in ("cpu", dev):
        pinit, pupd, _, pnet = make_train_population(gcfg, qtask, qp, KR,
                                                     device=where)
        if not isinstance(pnet, PopulationActorCriticCNN):
            raise AssertionError("population_rgb_update_parity: not the "
                                 "stacked CNN")
        ts = pinit(torch.Generator(where).manual_seed(SEED))
        if weights is None:
            weights = {k: v.clone() for k, v in
                       ts.network.state_dict().items()}
        ts.network.load_state_dict(weights)
        singles = [member_state(ts, k) for k in range(KR)]
        reset_counts()
        ts, metrics = pupd(ts, Draws(*(x.to(where) for x in draws)))
        sides[torch.device(where).type] = (
            ts, {k: v.tolist() for k, v in metrics.items()},
            (kernel_dyn.launches, kernel_render.launches), pupd.env_path)
    (cpu_ts, cpu_m, cpu_n, _), (card_ts, card_m, card_n, card_path) = \
        sides["cpu"], sides["cuda"]
    if card_n != (12, 12) or cpu_n != (0, 0) or card_path != "batched":
        raise AssertionError(f"population_rgb_update_parity: launches "
                             f"{card_n} on the card (one K1 and one render a "
                             f"control step for both members), {cpu_n} "
                             f"counted on the CPU, path {card_path}")
    prgb_param_err = state_err(card_ts.network.state_dict(),
                               cpu_ts.network.state_dict())
    prgb_metric_err = {k: max(abs(a - b) for a, b in zip(card_m[k],
                                                         cpu_m[k]))
                       for k in cpu_m}
    prgb_obs_ties = obs_ties("population_rgb_update_parity last_obs",
                             card_ts.last_obs, cpu_ts.last_obs.to(dev))
    moved = state_err(cpu_ts.network.state_dict(), weights)
    if prgb_param_err > PPO_PARAM_ATOL or moved < 100 * PPO_PARAM_ATOL \
            or not all(metric_close(a, b, PPO_METRIC_TOL) for k in cpu_m
                       for a, b in zip(card_m[k], cpu_m[k])):
        raise AssertionError(f"population_rgb_update_parity, card vs CPU: "
                             f"weights {prgb_param_err} (moved {moved}), "
                             f"metrics {prgb_metric_err}")
    member_param_err, member_metric_err = [], []
    for k in range(KR):
        one, m1 = pupd.single(singles[k], Draws(draws.noise[k].to(dev),
                                                draws.perms[k].to(dev)))
        member_param_err.append(state_err(
            card_ts.network.member(k).state_dict(),
            one.network.state_dict()))
        member_metric_err.append(max(abs(card_m[q][k] - float(v))
                                     for q, v in m1.items()))
        obs_ties(f"population_rgb_update_parity member {k} last_obs",
                 card_ts.last_obs[k], one.last_obs)
        if member_param_err[-1] > PPO_PARAM_ATOL or not all(
                metric_close(card_m[q][k], float(v), PPO_METRIC_TOL)
                for q, v in m1.items()):
            raise AssertionError(f"population_rgb_update_parity, member {k} "
                                 f"vs its own update: weights "
                                 f"{member_param_err[-1]}, metrics "
                                 f"{member_metric_err[-1]}")
    emit({"phase": "population_rgb_update_parity", "num_policies": KR,
          "num_envs": 16, "rollout_steps": 12,
          "launches": {"dyn_ctrl_step": card_n[0], "render": card_n[1]},
          "param_atol": PPO_PARAM_ATOL, "metric_tol": PPO_METRIC_TOL,
          "card_vs_cpu_param_max_abs_err": prgb_param_err,
          "card_vs_cpu_metric_max_abs_err": prgb_metric_err,
          "card_vs_cpu_last_obs_ties": prgb_obs_ties,
          "member_vs_single_param_max_abs_err": member_param_err,
          "member_vs_single_metric_max_abs_err": member_metric_err,
          "weights_moved": moved, "conv_precision": "ieee float32",
          "metrics_card": card_m})

    # ppo_population_rgb8x512: ppo_rgb512's configuration for each of K = 8
    # members (the K of the JAX package's population throughput
    # configuration, bench_all.py:142-181): 8 x 512 = 4096 envs a control
    # step, one K1 and one render launch a step for all members
    KP = 8
    reset_counts()
    pinit, pupd, _, _ = make_train_population(gcfg, ztask, zp, KP,
                                              device=dev)
    if pupd.env_path != "batched":
        raise AssertionError(f"ppo_population_rgb8x512: env path "
                             f"{pupd.env_path}")
    ts, prgb_updates = checked_updates(
        pupd, pinit(torch.Generator(dev).manual_seed(SEED)),
        "ppo_population_rgb8x512")
    prgb_counts = {"dyn_ctrl_step": kernel_dyn.launches,
                   "render": kernel_render.launches}
    # ppo_rgb512's counts: 2 updates of 32 steps, and the reset image
    if prgb_counts != {"dyn_ctrl_step": 2 * 32, "render": 2 * 32 + 1} \
            or kernel_fused.launches or kernel_pid.launches \
            or kernel_env.launches:
        raise AssertionError(f"ppo_population_rgb8x512: launches "
                             f"{prgb_counts}")
    # both kernels at the population's shapes, against their plain
    # versions: K1 without obs12 rows and the render kernel (rgba) at 8 x
    # 512 = 4096 cameras, bit for bit as at 256 and 512
    dyn_case(P.CF2X, KP * 512, False, timed="ppo_population_rgb8x512",
             gen=np.random.default_rng(SEED + 13))
    rng = np.random.default_rng(SEED + 14)
    render_case("landmark", 1, KP * 512, timed="ppo_population_rgb8x512")
    emit({"phase": "ppo_population_rgb8x512", "num_policies": KP,
          "num_envs": 512, "rollout_steps": 32, "env_path": "batched",
          "launches": prgb_counts, "updates": prgb_updates,
          "conv_precision": "ieee float32",
          "kernel_checks": checks[-1:] + render_checks[-1:]})

    # ---- randomized resets: make_batched_step with reset noise ----
    # The card's path against the CPU's plain versions from the same seed:
    # both draw the noise from one CPU generator (envs/fast.py ResetNoise),
    # so the draws are identical bit for bit.  hover4096 (K1, RPM) runs
    # free; the two routing fleets (K4 and K5, embedded DSL-PID) step from
    # the CPU's state at each step, as the PID paths of the rollout phases
    # do (two free-running PID paths drift apart; the drift is recorded).
    # A flag may differ only within FLAG_MARGIN of its threshold; such an
    # env resets on one side only and leaves the comparison (free run) or
    # that step's comparison (re-anchored).
    def no_noise(task):
        return dataclasses.replace(task, reset_pos_noise=0.0,
                                   reset_rpy_noise=0.0, reset_vel_noise=0.0)

    def on(device, state):
        return map_leaves(lambda x: x.to(device), state)

    def stepped_rows(flat, n):
        """Per drone, the obs12 rows `flag_margin` reads, from a flat state
        that was stepped and not reset."""
        rows = torch.cat([flat.pos, quat_ops.quat_to_rpy(flat.quat),
                          flat.vel, flat.ang_v], dim=-1)
        return [rows[d::n].t() for d in range(n)]

    def noise_rollout(name, cfg, task, b, action, anchored, steps=32):
        """`steps` control steps of `action` through make_batched_step on
        the card and on the CPU from one seed; returns the record and the
        card run's launch counts."""
        n, obs_dim = cfg.num_drones, task.obs_dim(cfg)
        spec = fused_spec(cfg, no_noise(task))
        routing = task.row_consts(cfg).task_id == TASK_ROUTING
        tol = PID_OBS_TOL if anchored else (ATOL, RTOL)
        otol = [torch.full((n * obs_dim,), t) for t in tol]
        if cfg.physics != Physics.DYN:
            for d in range(n):
                otol[0][d * obs_dim + 9:d * obs_dim + 12] = PYB_ANGV_TOL[0]
                otol[1][d * obs_dim + 9:d * obs_dim + 12] = PYB_ANGV_TOL[1]
        c_reset, c_step = make_batched_step(cfg, task, b, obs_layout="flat",
                                            device="cpu")
        _, c_free = make_batched_step(cfg, task, b, autoreset=False,
                                      obs_layout="flat", device="cpu")
        init = make_batched_step(cfg, no_noise(task), b,
                                 device="cpu")[0]()[0]
        acts = action.expand(b, n, -1).contiguous()
        acts_dev = acts.to(dev)
        reset_counts()
        g_reset, g_step = make_batched_step(cfg, task, b, obs_layout="flat",
                                            device=dev)
        cs, co = c_reset(SEED)
        gs, go = g_reset(SEED)
        err = check_close(f"{name} reset obs", go.cpu(), co, tol=otol)
        ok = torch.ones(b, dtype=torch.bool)
        flag_ties = nn_ties = resets = 0
        for t in range(steps):
            prev = cs
            if anchored:
                gs = on(dev, cs)
            cs, co, cr, cte, ctr = c_step(cs, acts)
            gs, go, gr, gte, gtr = g_step(gs, acts_dev)
            go, gr, gte, gtr = go.cpu(), gr.cpu(), gte.cpu(), gtr.cpu()
            differ = ok & ((gte != cte) | (gtr != ctr))
            if differ.any():
                free = c_free(prev, acts)[0]
                margin = flag_margin(spec, stepped_rows(free, n),
                                     prev.step_counter.float())
                if (differ & (margin > FLAG_MARGIN)).any():
                    raise AssertionError(f"{name}: flags differ away from "
                                         f"a tie at step {t}")
                flag_ties += int(differ.sum())
            keep = ok & ~differ
            if not anchored:
                ok = keep
            if routing:
                # a nearest neighbour decided by rounding: take the CPU's
                beyond = (go - co).abs() > otol[0] + otol[1] * co.abs()
                tie = nn_tie(cs.pos.reshape(b, n, 3))[:, None] & beyond
                tie[:, [c for c in range(n * obs_dim)
                        if c % obs_dim < obs_dim - 3]] = False
                nn_ties += int(tie.any(dim=1).sum())
                go = torch.where(tie, co, go)
            if keep.any():
                err = max(err, check_close(f"{name} obs t={t}", go[keep],
                                           co[keep], tol=otol),
                          check_close(f"{name} reward t={t}",
                                      gr[keep][None], cr[keep][None],
                                      tol=tol))
            # the card's reset states lie within the noise of the reset
            rows = (gte | gtr).repeat_interleave(n)
            resets += int((gte | gtr).sum())
            if rows.any():
                r_dev = rows.to(dev)
                dev_of = {
                    "pos": ((gs.pos[r_dev].cpu() - init.pos[rows]).abs(),
                            task.reset_pos_noise),
                    "rpy": (quat_ops.quat_to_rpy(gs.quat[r_dev]).abs().cpu(),
                            task.reset_rpy_noise),
                    "vel": (gs.vel[r_dev].abs().cpu(),
                            task.reset_vel_noise)}
                for what, (x, bound) in dev_of.items():
                    if float(x.max()) > bound + 1e-5:
                        raise AssertionError(f"{name}: a reset {what} "
                                             f"{float(x.max())} beyond "
                                             f"{bound}")
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        g_noise, c_noise = g_step.reset_noise(), c_step.reset_noise()
        if not (g_noise.index == c_noise.index == steps + 1 and torch.equal(
                g_noise.block.cpu(), c_noise.block)):
            raise AssertionError(f"{name}: the card's draws are not the "
                                 "CPU's")
        if resets == 0:
            raise AssertionError(f"{name}: no env was reset")
        out = {"envs": b, "steps": steps, "anchored": anchored,
               "card_vs_cpu_max_abs_err": err, "resets": resets,
               "flag_ties": flag_ties, "envs_left_out": int((~ok).sum()),
               "draws_bitwise_equal": True, "draws": c_noise.index,
               "noise": [task.reset_pos_noise, task.reset_rpy_noise,
                         task.reset_vel_noise],
               "action": action.reshape(-1).tolist(), "launches": counts}
        if routing:
            out["nearest_neighbour_ties"] = nn_ties
        if anchored:
            # for the record, held to no tolerance: 8 free-running steps
            cs, _ = c_reset(SEED)
            gs, _ = g_reset(SEED)
            drift = []
            for t in range(8):
                cs, co = c_step(cs, acts)[:2]
                gs, go = g_step(gs, acts_dev)[:2]
                drift.append(float((go.cpu() - co).abs().max()))
            out["free_running_obs_drift_by_step"] = drift
        return out, counts

    tilt = torch.tensor([1.0, 1.0, -1.0, -1.0])
    noise_cases = (
        # Hover on DYN (K1): the JAX package's randomized-reset test's
        # noise and a velocity term; the tilt action rolls the drones over
        # the 0.4 rad limit
        ("hover4096", hover_cfg(), HoverTask(
            act=ActionType.RPM, reset_pos_noise=0.2, reset_rpy_noise=0.1,
            reset_vel_noise=0.05), 4096, tilt, False),
        # routing on DYN (K4): a lateral waypoint tumbles the drones (the
        # DYN roll-torque quirk) beyond the 0.8 rad limit
        ("routing4x4096", rcfg, dataclasses.replace(
            rtask, reset_pos_noise=0.05, reset_rpy_noise=0.3,
            reset_vel_noise=0.2), 4096, torch.tensor([1.0, 0.0, 0.0]),
         True),
        # routing on PYB (K5): no waypoint tilts a PYB drone past 0.8 rad,
        # so the attitude noise reaches beyond it (0.9 rad): an env that
        # draws such a tilt truncates on its first step and redraws
        ("routing4x4096_pyb", pcfg, dataclasses.replace(
            ptask, reset_pos_noise=0.05, reset_rpy_noise=0.9,
            reset_vel_noise=0.2), 4096, torch.tensor([1.0, 0.0, 0.0]),
         True))
    noise_records, noise_counts = {}, {}
    for name, ncfg, ntask, nb, nact, anchored in noise_cases:
        rec, counts = noise_rollout(name, ncfg, ntask, nb, nact, anchored)
        noise_counts[name] = counts
        noise_records[name] = rec
    expect = {"hover4096": "dyn_ctrl_step",
              "routing4x4096": "pid_dyn_ctrl_step",
              "routing4x4096_pyb": "env_ctrl_step"}
    for name, counts in noise_counts.items():
        if counts != {expect[name]: 32}:
            raise AssertionError(f"reset_noise {name}: launches {counts}")
    emit({"phase": "reset_noise", "cases": noise_records,
          "note": "card against the CPU's plain versions from one seed; "
                  "hover free-running, routing re-anchored on the CPU's "
                  "state at each step"})

    # ---- the class adapters: each aviary on the card against the CPU ----
    # core.step on the card is plain tensor code (no kernel); the drones'
    # cameras are one render launch a call.  The reset obs of the DYN
    # aviaries must be equal, the PYB ones (attitudes from a yaw) within
    # the tolerances; 8 steps re-anchored on the CPU's state.
    from gym_pybullet_drones_tpu_torch.envs import gym_adapter as gad
    from gym_pybullet_drones_tpu_torch.examples import pid as pid_example
    # examples/pid.py's helix start
    pid_xyz = np.array([[0.3 * np.cos(i / 6 * 2 * np.pi + np.pi / 2),
                         0.3 * np.sin(i / 6 * 2 * np.pi + np.pi / 2) - 0.3,
                         0.1 + i * 0.05] for i in range(3)])
    pid_rpy = np.array([[0, 0, i * (np.pi / 2) / 3] for i in range(3)])
    vel_xyz = np.array([[0, 0, .1], [.3, 0, .1], [.6, 0, .1], [.9, 0, .1]])
    vel_rpy = np.array([[0, 0, 0], [0, 0, np.pi / 3], [0, 0, np.pi / 4],
                        [0, 0, np.pi / 2]])
    arng = np.random.default_rng(SEED + 10)
    adapter_cases = (
        # examples/pid.py's configuration: 3 drones, PYB, obstacles, 240/48
        ("CtrlAviary", lambda d: gad.CtrlAviary(
            num_drones=3, initial_xyzs=pid_xyz, initial_rpys=pid_rpy,
            physics=Physics.PYB, neighbourhood_radius=10, pyb_freq=240,
            ctrl_freq=48, obstacles=True, device=d),
         lambda e: e.HOVER_RPM * (1 + 0.02 * arng.normal(size=(3, 4))),
         False),
        # examples/pid_velocity.py's: 4 drones, PYB, 240/48
        ("VelocityAviary", lambda d: gad.VelocityAviary(
            num_drones=4, initial_xyzs=vel_xyz, initial_rpys=vel_rpy,
            physics=Physics.PYB, neighbourhood_radius=10, pyb_freq=240,
            ctrl_freq=48, device=d),
         lambda e: np.concatenate([arng.normal(size=(4, 3)),
                                   arng.uniform(size=(4, 1))], axis=-1),
         False),
        ("HoverAviary", lambda d: gad.HoverAviary(physics=Physics.DYN,
                                                  device=d),
         lambda e: arng.uniform(-1, 1, size=(1, 4)), True),
        ("MultiHoverAviary", lambda d: gad.MultiHoverAviary(
            physics=Physics.DYN, device=d),
         lambda e: arng.uniform(-1, 1, size=(2, 4)), True))
    adapter_records = {}
    reset_counts()
    for name, make, act_of, dyn in adapter_cases:
        envs = {"cpu": make("cpu"), "cuda": make(dev)}
        obs = {k: e.reset(seed=SEED)[0] for k, e in envs.items()}
        pid_path = name == "VelocityAviary"
        tol = PID_OBS_TOL if pid_path else (ATOL, RTOL)
        ctol = [np.full(obs["cpu"].shape[-1], t) for t in tol]
        if not dyn:
            # the state vector's world ang-vel columns
            ctol[0][13:16], ctol[1][13:16] = PYB_ANGV_TOL
        if dyn and not np.array_equal(obs["cuda"], obs["cpu"]):
            raise AssertionError(f"{name}: the card's reset obs differs")

        def close(g, c, what, atol=ctol[0], rtol=ctol[1]):
            if not np.all(np.abs(g - c) <= atol + rtol * np.abs(c)):
                raise AssertionError(f"{name}: {what} beyond the tolerance, "
                                     f"max abs err {np.abs(g - c).max()}")
            return float(np.abs(g - c).max())
        err = close(obs["cuda"], obs["cpu"], "reset obs")
        for t in range(8):
            envs["cuda"].state = on(dev, envs["cpu"].state)
            a = act_of(envs["cpu"]).astype(np.float32)
            (co, cr, cte, ctr, _), (go, gr, gte, gtr, _) = (
                envs["cpu"].step(a), envs["cuda"].step(a))
            err = max(err, close(go, co, f"obs t={t}"),
                      close(np.float32(gr), np.float32(cr), f"reward t={t}",
                            *tol))
            if (cte, ctr) != (gte, gtr):
                raise AssertionError(f"{name}: flags differ at step {t}")
        adapter_records[name] = {
            "num_drones": envs["cpu"].NUM_DRONES,
            "physics": envs["cpu"].cfg.physics.value,
            "reset_obs_equal": bool(np.array_equal(obs["cuda"], obs["cpu"])),
            "card_vs_cpu_max_abs_err": err}
    # the cameras of examples/pid.py's fleet, after its 8 steps: the
    # kernel (with depth and seg) against its plain version on the card
    ctrl = adapter_cases[0][1](dev)
    ctrl.reset()
    for _ in range(8):
        ctrl.step(np.full((3, 4), ctrl.HOVER_RPM * 1.01, np.float32))
    before = kernel_render.launches
    images = [ctrl.getDroneImages(d) for d in range(3)]
    image_launches = kernel_render.launches - before
    plain = kernel_render.render_drones_plain(
        P.CF2X, render.landmark_scene(), ctrl.state.pos, ctrl.state.quat, 3)
    for d, (rgb, dep, seg) in enumerate(images):
        if not (np.array_equal(rgb, plain[0][d].reshape(48, 64, 4).cpu()
                               .numpy())
                and np.array_equal(dep, plain[1][d].cpu().numpy())
                and np.array_equal(seg, plain[2][d].cpu().numpy())):
            raise AssertionError(f"getDroneImages({d}): not bit for bit "
                                 "its plain version")
    # rpm_override on the card: a HoverAviary state stepped with raw rpm
    # is CtrlAviary's step with that rpm, bit for bit, and leaves the
    # action ring alone
    rl_env = gad.HoverAviary(physics=Physics.DYN, device=dev)
    rl_env.reset()
    for _ in range(3):
        rl_env.step(np.full((1, 4), 0.2, np.float32))
    rpm = torch.full((1, 4), rl_env.HOVER_RPM * 1.02, device=dev)
    over = core.step(rl_env.cfg, rl_env.task, rl_env.state, None,
                     rpm_override=rpm)[0]
    direct = gad.CtrlAviary(physics=Physics.DYN, pyb_freq=240, ctrl_freq=30,
                            device=dev)
    if direct.cfg != rl_env.cfg:
        raise AssertionError("rpm_override: the configurations differ")
    direct.state = rl_env.state
    direct.step(rpm)
    for f in ("pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm",
              "step_counter"):
        if not torch.equal(getattr(over, f), getattr(direct.state, f)):
            raise AssertionError(f"rpm_override: {f} differs from "
                                 "CtrlAviary's step")
    if not torch.equal(over.action_buffer, rl_env.state.action_buffer):
        raise AssertionError("rpm_override pushed the action ring")
    torch.cuda.synchronize()
    adapter_counts = {k: v for k, v in launch_counts().items() if v}
    if adapter_counts != {"render": 3} or image_launches != 3:
        raise AssertionError(f"gym_adapter: launches {adapter_counts}")
    # the render kernel at getDroneImages' shape: 3 cameras with depth and
    # seg, 24 bytes a pixel written
    cam_pos, cam_quat = ctrl.state.pos, ctrl.state.quat
    scene = render.landmark_scene()
    run_img = lambda: kernel_render.render_drones(
        P.CF2X, scene, cam_pos, cam_quat, 3, depth_seg=True)
    plain_img = lambda: kernel_render.render_drones_plain(
        P.CF2X, scene, cam_pos, cam_quat, 3)
    npix = 3 * 48 * 64
    img_ops = render_ops_per_pixel(len(scene.sphere_radius),
                                   len(scene.box_id), 3)
    bms, by = bound_ms(24 * npix + 28 * 3, img_ops * npix)
    summary[("render", "gym_adapter_images")] = {
        "max_abs_err": 0.0, "ms": graph_ms(run_img),
        "plain_ms": eager_ms(plain_img, 5, 1), "bound_ms": bms,
        "bound_by": by,
        "geometry": _build.launch_geometry("render", 3, 48 * 64)}
    emit({"phase": "gym_adapter", "aviaries": adapter_records,
          "images_bitwise_equal": True, "image_launches": image_launches,
          "rpm_override_equals_ctrl_step": True,
          "launches": adapter_counts})

    # ---- the examples: pid.py (cut) and swarm.py at full width ----
    reset_counts()
    logger = pid_example.run(plot=False, duration_sec=2, device=dev,
                             output_folder="build/chip_smoke/pid")
    z_err = [abs(float(np.mean(logger.states[j, 2, -48:]))
                 - (0.1 + j * 0.05)) for j in range(3)]
    if max(z_err) >= 0.1:
        raise AssertionError(f"pid.py: altitude errors {z_err}")
    pid_counts = {k: v for k, v in launch_counts().items() if v}
    if pid_counts:
        raise AssertionError(f"pid.py launched kernels: {pid_counts}")
    from gym_pybullet_drones_tpu_torch.examples import swarm as swarm_example
    reset_counts()
    sw_envs, sw_drones, sw_sec = 4096, 4, 8       # swarm.py's defaults
    _, sw_state, arrived, mean_err, sw_steps, _ = swarm_example.fly(
        sw_envs, sw_drones, sw_sec, dev)
    torch.cuda.synchronize()
    swarm_counts = {k: v for k, v in launch_counts().items() if v}
    if swarm_counts != {"env_ctrl_step": sw_steps + 1}:
        raise AssertionError(f"swarm.py: launches {swarm_counts}")
    # every fleet flies the same plan from the same start: the 4096 fleets
    # end bit for bit alike; and the CPU's plain versions fly one fleet
    # the same 8 s: the same drones arrive (within 15 cm of their goals)
    sw_pos = sw_state.pos.reshape(sw_envs, sw_drones, 3)
    if not torch.equal(sw_pos, sw_pos[:1].expand_as(sw_pos)):
        raise AssertionError("swarm.py: the fleets differ from one another")
    _, ref_state, ref_arrived, ref_err, _, _ = swarm_example.fly(
        1, sw_drones, sw_sec, "cpu")
    goals = torch.tensor(make_routing_config(num_drones=sw_drones)[1]
                         .destinations)
    card_goal_err = torch.linalg.norm(sw_pos[0].cpu() - goals, dim=-1)
    cpu_goal_err = torch.linalg.norm(ref_state.pos - goals, dim=-1)
    if not (torch.isfinite(sw_pos).all() and arrived > 0
            and torch.equal(card_goal_err < 0.15, cpu_goal_err < 0.15)):
        raise AssertionError(f"swarm.py: goal errors {card_goal_err} on the "
                             f"card, {cpu_goal_err} on the CPU")
    emit({"phase": "examples",
          "pid": {"duration_sec": 2, "control_steps": 96,
                  "cut": "2 s of flight (96 control steps) of the 12 s "
                         "demo", "altitude_errors": z_err},
          "swarm": {"envs": sw_envs, "drones": sw_drones,
                    "duration_sec": sw_sec, "control_steps": sw_steps,
                    "arrived_share": arrived, "mean_goal_error": mean_err,
                    "launches": swarm_counts, "fleets_bitwise_equal": True,
                    "goal_errors": card_goal_err.tolist(),
                    "cpu_one_fleet": {"arrived_share": ref_arrived,
                                      "goal_errors": cpu_goal_err.tolist()}},
          "note": "the CPU's fleet is the plain versions' reference, "
                  "free-running, compared by which drones arrive"})
    # ---- the routing learning run (examples/train_to_threshold.py
    # --routing): the committed configuration at full width, cut to a few
    # updates, each followed by the run's evaluation (64 envs x 480
    # control steps under the policy mean) ----
    rrcfg, rrtask = make_routing_config(num_drones=3, spacing=0.4)  # PYB
    rr_updates, rr_eval_envs = 4, 64
    rr_horizon = int(rrtask.episode_len_sec * rrcfg.ctrl_freq)     # 480
    rppo = PPOConfig(num_envs=128, rollout_steps=64, num_minibatches=4,
                     update_epochs=10, lr=3e-4, anneal_lr=True, gamma=0.99,
                     log_std_init=-1.0, hidden=(128, 128),
                     total_timesteps=400 * 128 * 64)
    rinit, rupdate, _, _ = make_train(rrcfg, rrtask, rppo, device=dev)
    if rupdate.env_path != "fused":
        raise AssertionError(f"routing_learn on {rupdate.env_path}")
    arrival_rate = make_arrival_rate(rrcfg, rrtask, rr_eval_envs,
                                     rr_horizon, dev)
    rts = rinit(torch.Generator(dev).manual_seed(SEED))
    reset_counts()
    rr_runs = []
    for _ in range(rr_updates):
        rts, (m,) = checked_updates(rupdate, rts, "routing_learn", n=1,
                                    k2_per_update=64)
        before = kernel_env.launches
        rate, ever, rstate = arrival_rate(rts.network)
        rate = float(rate)
        if kernel_env.launches - before != rr_horizon:
            raise AssertionError("routing_learn: K5 launches per evaluation")
        # the reset is deterministic and so is the policy mean: the 64 envs
        # fly one episode, bit for bit, and the rate is all or nothing
        for k, leaf in enumerate(leaves(rstate)):
            per_env = leaf.reshape(rr_eval_envs, -1)
            if not torch.equal(per_env, per_env[:1].expand_as(per_env)):
                raise AssertionError(f"routing_learn: the evaluation's envs "
                                     f"differ (leaf {k})")
        if rate not in (0.0, 1.0) or bool(ever.all()) != (rate == 1.0):
            raise AssertionError(f"routing_learn: rate {rate}")
        rr_runs.append({"metrics": m, "all_arrivals_rate": rate})
    torch.cuda.synchronize()
    rr_counts = {k: v for k, v in launch_counts().items() if v}
    if rr_counts != {"fused_env_step": 64 * rr_updates,
                     "env_ctrl_step": rr_horizon * rr_updates}:
        raise AssertionError(f"routing_learn: launches {rr_counts}")
    rr_learn_counts = {"fused_env_step": rr_counts["fused_env_step"]}
    rr_eval_counts = {"env_ctrl_step": rr_counts["env_ctrl_step"]}

    # the evaluator on the card against the CPU from the same weights,
    # re-anchored on the CPU's state at each step (two free-running
    # embedded-PID paths drift apart), over a cut horizon: the same action
    # (the CPU policy's mean) into both
    cpu_net = copy.deepcopy(rts.network).cpu()
    c_reset, c_step = make_batched_step(rrcfg, rrtask, rr_eval_envs,
                                        autoreset=False, obs_layout="flat",
                                        device="cpu")
    g_reset, g_step = make_batched_step(rrcfg, rrtask, rr_eval_envs,
                                        autoreset=False, obs_layout="flat",
                                        device=dev)
    rspec = fused_spec(rrcfg, rrtask)
    r_obs = rrtask.obs_dim(rrcfg)
    otol = [torch.full((3 * r_obs,), t) for t in PID_OBS_TOL]
    for d in range(3):
        otol[0][d * r_obs + 9:d * r_obs + 12] = PYB_ANGV_TOL[0]
        otol[1][d * r_obs + 9:d * r_obs + 12] = PYB_ANGV_TOL[1]
    cs, co = c_reset()
    gs, go = g_reset()
    eval_err = check_close("routing eval reset obs", go.cpu(), co, tol=otol)
    eval_nn_ties = eval_flag_ties = 0
    for t in range(16):
        with torch.no_grad():
            a = cpu_net(co)[0].reshape(rr_eval_envs, 3, -1)
        prev, gs = cs, on(dev, cs)
        cs, co, cr, cte, ctr = c_step(cs, a)
        gs, go, gr, gte, gtr = g_step(gs, a.to(dev))
        go, gr, gte, gtr = go.cpu(), gr.cpu(), gte.cpu(), gtr.cpu()
        differ = (gte != cte) | (gtr != ctr)
        if differ.any():
            # no auto-reset: the CPU's next state is the stepped state
            margin = flag_margin(rspec, stepped_rows(cs, 3),
                                 prev.step_counter.float())
            if (differ & (margin > FLAG_MARGIN)).any():
                raise AssertionError(f"routing eval: flags differ away from "
                                     f"a tie at step {t}")
            eval_flag_ties += int(differ.sum())
        # a nearest neighbour decided by rounding (the drones start on a
        # line at equal spacing): take the CPU's
        beyond = (go - co).abs() > otol[0] + otol[1] * co.abs()
        tie = nn_tie(cs.pos.reshape(rr_eval_envs, 3, 3))[:, None] & beyond
        tie[:, [c for c in range(3 * r_obs) if c % r_obs < r_obs - 3]] = \
            False
        eval_nn_ties += int(tie.any(dim=1).sum())
        go = torch.where(tie, co, go)
        keep = ~differ
        eval_err = max(eval_err, check_close(
            f"routing eval obs t={t}", go[keep], co[keep], tol=otol),
            check_close(f"routing eval reward t={t}", gr[keep][None],
                        cr[keep][None], tol=PID_OBS_TOL))
    # the two kernels at the run's shapes, against their plain versions:
    # K2 (d) with the PID family and the routing hooks at the trainer's
    # 128 envs, K5 with the PID preamble at the evaluator's 64
    rng = np.random.default_rng(SEED + 11)
    fused_case("routing3x128_pyb_learn", rrcfg, rrtask, 128)
    env_case(Physics.PYB, 3, True, True, P.CF2X, rr_eval_envs,
             timed="routing3x64_pyb_eval", obstacles=())
    rr_kernel_checks = checks[-2:]
    emit({"phase": "routing_learn",
          "config": {"num_drones": 3, "spacing": 0.4,
                     "physics": rrcfg.physics.value, "num_envs": 128,
                     "rollout_steps": 64, "epochs": 10, "minibatches": 4,
                     "hidden": [128, 128], "lr": 3e-4, "anneal": True,
                     "log_std_init": -1.0, "eval_envs": rr_eval_envs,
                     "eval_steps": rr_horizon},
          "updates": rr_runs, "launches": rr_counts,
          "eval_envs_bitwise_equal": True,
          "eval_card_vs_cpu": {"steps": 16, "anchored": True,
                               "max_abs_err": eval_err,
                               "flag_ties": eval_flag_ties,
                               "nearest_neighbour_ties": eval_nn_ties},
          "kernel_checks": rr_kernel_checks})

    # ---- the host-side loops: CFAviary with the firmware, cf.py,
    # BetaAviary over loopback UDP (both bridges), debug.py's probes, a
    # checkpoint on the card ----
    from gym_pybullet_drones_tpu_torch import native
    from gym_pybullet_drones_tpu_torch.envs.beta_aviary import (
        BASE_PORT_PWM, BASE_PORT_RC, BASE_PORT_STATE, BetaAviary)
    from gym_pybullet_drones_tpu_torch.envs.cf_aviary import CFAviary
    from gym_pybullet_drones_tpu_torch.examples import cf as cf_example
    from gym_pybullet_drones_tpu_torch.examples import debug as debug_example
    from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
        restore_checkpoint, save_checkpoint)
    reset_counts()
    cf_records = {}
    for controller, fw_freq in (("mellinger", 500), ("pid", 1000),
                                ("dsl", 1000)):
        steps = 480 * 25 // fw_freq                # about 480 ticks each
        flights, ticks = {}, {}
        for where in ("cpu", dev):
            env = type("CF", (CFAviary,), {"CONTROLLER": controller})(
                initial_xyzs=np.array([[0.0, 0.0, 0.1]]), pyb_freq=fw_freq,
                ctrl_freq=25, device=where)
            obs_log = []
            for i in range(steps):
                if i == 1:
                    env.sendTakeoffCmd(0.5, 0.4)
                if i == steps // 2:
                    env.sendFullStateCmd([0.2, 0.1, 0.5], np.zeros(3),
                                         np.zeros(3), 0.3, np.zeros(3),
                                         i / 25)
                obs_log.append(env.step(i)[0][0])
            flights[str(where)] = np.stack(obs_log)
            ticks[str(where)] = env.tick
            if not np.isfinite(flights[str(where)]).all():
                raise AssertionError(f"CFAviary {controller} on {where}: "
                                     "non-finite obs")
            env.close()
        # the scheduling compares differences of Python floats, so a run's
        # tick count is 480 give or take one, the same on both devices
        if ticks["cpu"] != ticks[str(dev)] or abs(ticks["cpu"] - 480) > 1:
            raise AssertionError(f"CFAviary {controller}: ticks {ticks}")
        drift = np.abs(flights[str(dev)] - flights["cpu"])
        # the card against the CPU, free-running, both float32: position
        # within CF_POS_DRIFT, the state columns within the ang-vel rows'
        # tolerance, the rpm columns within the PID paths' rpm tolerance
        ref = np.abs(flights["cpu"])
        within = lambda cols, tol: bool(
            (drift[:, cols] <= tol[0] + tol[1] * ref[:, cols]).all())
        if not (drift[:, 0:3].max() <= CF_POS_DRIFT
                and within(slice(0, 16), PYB_ANGV_TOL)
                and within(slice(16, 20), PID_RPM_TOL)):
            raise AssertionError(
                f"CFAviary {controller}: the card drifts from the CPU by "
                f"{drift[:, 0:3].max()} m, {drift[:, 0:16].max()} in the "
                f"state, {drift[:, 16:20].max()} rpm")
        cf_records[controller] = {
            "firmware_hz": fw_freq, "ticks": ticks["cpu"],
            "control_steps": steps,
            "card_vs_cpu_max_pos_drift": float(drift[:, 0:3].max()),
            "card_vs_cpu_max_state_drift": float(drift[:, 0:16].max()),
            "card_vs_cpu_max_rpm_drift": float(drift[:, 16:20].max()),
            "final_pos": flights[str(dev)][-1, 0:3].tolist()}
    cf_logger = cf_example.run(plot=False, duration_fraction=0.05,
                               output_folder="build/chip_smoke/cf",
                               device=dev)
    if cf_logger.states.shape != (1, 16, 26) \
            or not np.isfinite(cf_logger.states).all():
        raise AssertionError(f"cf.py: states {cf_logger.states.shape}")

    def beta_loopback(ip, native_bridge, steps=80):
        """A BetaAviary of one drone on the card (48 Hz physics and
        control) against listener sockets on `ip`, answering with a fixed
        PWM packet from t = 1.2 s: packets seen, and the rpm the reply
        turns into."""
        fdm, rc = (socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                   for _ in range(2))
        reply = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        env = None
        try:
            fdm.bind((ip, BASE_PORT_STATE))
            rc.bind((ip, BASE_PORT_RC))
            fdm.settimeout(2.0)
            rc.settimeout(2.0)
            env = BetaAviary(num_drones=1, pyb_freq=48, ctrl_freq=48,
                             udp_ip=ip, use_native_bridge=native_bridge,
                             device=dev)
            seen, last_rc = 0, None
            for i in range(steps):
                env.step(np.array([[12.0, 0.2, -0.1, 0.05]]), i)
                struct.unpack("@dddddddddddddddddd", fdm.recv(1024))
                last_rc = struct.unpack("@dHHHHHHHHHHHHHHHH", rc.recv(1024))
                seen += 2
                if i / 48 >= 1.2:
                    reply.sendto(struct.pack("@ffff", 0.1, 0.2, 0.3, 0.4),
                                 (ip, BASE_PORT_PWM))
            rpm = env.state.last_rpm[0].cpu().numpy()
        finally:
            if env is not None:
                env.close()
            for s in (fdm, rc, reply):
                s.close()
        u = np.float32([0.3, 0.2, 0.4, 0.1])        # the [2, 1, 3, 0] remap
        want = np.sqrt(P.CF2X.max_thrust / 4 / P.CF2X.kf * u)
        if not np.allclose(rpm, want, rtol=1e-6) or last_rc[5] != 1500:
            raise AssertionError(f"BetaAviary on {ip}: rpm {rpm}, want "
                                 f"{want}; rc {last_rc}")
        return {"ip": ip, "native_bridge": native_bridge, "steps": steps,
                "packets_seen": seen, "rpm_from_fixed_pwm": rpm.tolist(),
                "last_rc": list(last_rc[1:6])}
    native.build("sitl_bridge")
    # the port's Mellinger controller (float64, as CFAviary runs it on the
    # host) against the C++ firmware oracle over tests/
    # test_firmware_oracle.py's takeoff -> goto -> land loop: 5 s of the
    # 500 Hz controller sampled at 100 Hz, a crude plant driven by the
    # oracle's output, so a difference is the controllers' alone
    from gym_pybullet_drones_tpu_torch.control import firmware as fw
    from gym_pybullet_drones_tpu_torch.native import firmware_oracle
    native.build("cf_firmware_oracle")
    f64 = lambda x: torch.tensor(np.asarray(x, np.float64))
    fdt, fticks = 1.0 / 500.0, 5 * 500
    t_fw = np.arange(fticks) * fdt
    wz = np.clip(t_fw / 2.0, 0, 1) * 0.5
    wz = np.where(t_fw > 6.0, np.maximum(0.0, 0.5 - 0.5 * (t_fw - 6.0) / 2.0),
                  wz)
    wps = np.stack([np.clip((t_fw - 3.0) / 2.0, 0, 1) * 0.4,
                    np.zeros_like(t_fw), wz], axis=-1)
    fw_state = fw.firmware_init(torch.float64)
    mel = firmware_oracle.MellingerOracle()
    unit_q, z3 = np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3)
    fpos, fvel, frpy, fgyro = (np.zeros(3) for _ in range(4))
    oracle_err, oracle_ticks = 0.0, 0
    for i in range(0, fticks, 5):
        fq = quat_ops.rpy_to_quat(f64(frpy)).numpy()
        sp = fw.Setpoint(f64(wps[i]), f64(z3), f64(z3), f64(z3), f64(unit_q))
        mine, fw_state = fw.mellinger_control(fw_state, sp, f64(fpos),
                                              f64(fvel), f64(fq), f64(fgyro),
                                              fdt)
        ref = mel.tick(wps[i], z3, z3, z3, unit_q, fpos, fvel, fq, fgyro,
                       fdt)
        oracle_err = max(oracle_err, float(np.abs(mine.numpy() - ref).max()))
        oracle_ticks += 1
        acc = np.array([np.sin(frpy[1]), -np.sin(frpy[0]),
                        np.cos(frpy[0]) * np.cos(frpy[1])]) \
            * ref[0] / fw.MASS_THRUST / fw.VEHICLE_MASS - [0.0, 0.0, 9.81]
        fvel = fvel + 5 * fdt * acc
        fpos = fpos + 5 * fdt * fvel
        rate = np.array([ref[1], -ref[2], ref[3]]) / 6e5
        frpy = 0.95 * frpy + 5 * fdt * rate
        fgyro = rate * 180.0 / np.pi * 0.2
    if not (oracle_err < FIRMWARE_ORACLE_ATOL and fpos[2] > 0.1):
        raise AssertionError(f"firmware oracle: the port's Mellinger "
                             f"control is {oracle_err} from the C++ oracle "
                             f"(bound {FIRMWARE_ORACLE_ATOL}); final "
                             f"height {fpos[2]}")
    beta_records = [beta_loopback("127.0.0.2", False),
                    beta_loopback("127.0.0.3", True)]
    probes = {"card": debug_example.probes(dev),
              "cpu": debug_example.probes("cpu")}
    debug_drift = {name: max(float((getattr(s, k).cpu()
                                    - getattr(probes["cpu"][name], k))
                                   .abs().max())
                             for k in ("pos", "quat", "vel", "ang_v"))
                   for name, s in probes["card"].items()}
    if not float(probes["card"]["obstacle"].pos[0, 0]) < 0.5:
        raise AssertionError("debug.py: the beam did not stop the drone")
    if max(debug_drift.values()) > DEBUG_DRIFT:
        raise AssertionError(f"debug.py: the card's probes drift from the "
                             f"CPU's by {debug_drift}")
    host_counts = {k: v for k, v in launch_counts().items() if v}
    if host_counts:
        raise AssertionError(f"host loops launched kernels: {host_counts}")
    # a checkpoint of the routing trainer on the card, restored into a
    # fresh learner; one more update from each
    path = save_checkpoint("build/chip_smoke/ckpt", rts, step=rr_updates)
    restored = restore_checkpoint(
        path, rinit(torch.Generator(dev).manual_seed(SEED + 1)))
    a1, m1 = rupdate(rts)
    a2, m2 = rupdate(restored)
    ckpt_diff = max(float((x - y).abs().max()) for x, y in zip(
        list(a1.network.state_dict().values()) + leaves(a1.env_state)
        + list(a1.opt_state.mu) + list(a1.opt_state.nu),
        list(a2.network.state_dict().values()) + leaves(a2.env_state)
        + list(a2.opt_state.mu) + list(a2.opt_state.nu)))
    if ckpt_diff != 0.0 or any(float(m1[k]) != float(m2[k]) for k in m1):
        raise AssertionError(f"checkpoint: the resumed update differs by "
                             f"{ckpt_diff}")
    # the same with a task with reset noise (the batched path, its stream
    # in the checkpoint), an evaluation between the save and the resumes
    ntask = HoverTask(act=ActionType.RPM, reset_pos_noise=0.2,
                      reset_rpy_noise=0.1, episode_len_sec=0.2)
    ninit, nupdate, nevaluate, _ = make_train(
        AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30), ntask,
        PPOConfig(num_envs=64, rollout_steps=8, num_minibatches=2,
                  update_epochs=1), device=dev)
    nts, _ = nupdate(ninit(torch.Generator(dev).manual_seed(SEED)))
    npath = save_checkpoint("build/chip_smoke/ckpt_noise", nts, step=1)
    nrestored = restore_checkpoint(
        npath, ninit(torch.Generator(dev).manual_seed(SEED + 1)))
    nevaluate(nts.network, num_steps=2)
    b1, n1 = nupdate(nts)
    b2, n2 = nupdate(nrestored)
    noise_ckpt_diff = max(float((x - y).abs().max()) for x, y in zip(
        list(b1.network.state_dict().values()) + leaves(b1.env_state)
        + [b1.last_obs, b1.reset_noise.block],
        list(b2.network.state_dict().values()) + leaves(b2.env_state)
        + [b2.last_obs, b2.reset_noise.block]))
    if (noise_ckpt_diff != 0.0 or b1.reset_noise.index < 2
            or b1.reset_noise.index != b2.reset_noise.index
            or any(float(n1[k]) != float(n2[k]) for k in n1)):
        raise AssertionError(f"checkpoint with reset noise: the resumed "
                             f"update differs by {noise_ckpt_diff}")
    emit({"phase": "host_loops", "cf_aviary": cf_records,
          "cf_py": {"duration_fraction": 0.05, "control_steps": 26,
                    "ticks": 520},
          "beta_aviary": beta_records,
          "firmware_oracle": {"sequence": "mellinger takeoff-goto-land",
                              "ticks": oracle_ticks,
                              "max_abs_err": oracle_err,
                              "atol": FIRMWARE_ORACLE_ATOL},
          "debug_probes": {"card_vs_cpu_max_abs_drift": debug_drift},
          "checkpoint": {"path": path, "resume_max_abs_diff": ckpt_diff,
                         "resume_bitwise_equal": True,
                         "reset_noise_resume_max_abs_diff": noise_ckpt_diff,
                         "reset_noise_draws": b1.reset_noise.index},
          "launches": host_counts,
          "drift_bounds": {"cf_pos_m": CF_POS_DRIFT,
                           "cf_state": PYB_ANGV_TOL, "cf_rpm": PID_RPM_TOL,
                           "debug_probes": DEBUG_DRIFT},
          "note": "drift: card against CPU, free-running, held to "
                  "drift_bounds ((atol, rtol) where a pair)"})
    for name, key in (("reset_noise_hover4096", ("dyn_ctrl_step",
                                                 "hover4096")),
                      ("reset_noise_routing4x4096", ("pid_dyn_ctrl_step",
                                                     "routing4x4096")),
                      ("reset_noise_routing4x4096_pyb", (
                          "env_ctrl_step", "routing4x4096_pyb")),
                      ("swarm4096x4", ("env_ctrl_step",
                                       "routing4x4096_pyb"))):
        # the same kernel at the same shape, timed above
        summary[(key[0], name)] = dict(summary[key], timed_as=key[1])

    # ---- sharded: data-parallel training over ranks (parallel/), the
    # JAX package's multi-chip matrix; each rank its own process ----
    from gym_pybullet_drones_tpu_torch.parallel.launch import run_ranks
    from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
        restore_checkpoint as restore_ckpt)
    matrix = sharded_matrix()
    np_ = lambda x: x.detach().cpu().numpy()
    reference = {}
    for name, (scfg, stask, spp, spath, _) in matrix.items():
        sinit, supdate, _, _ = make_train(scfg, stask, spp, device=dev,
                                          env_path=spath)
        sts, sm = supdate(sinit(torch.Generator(dev).manual_seed(SEED)))
        reference[name] = {
            "params": {k: np_(v) for k, v in sts.network.state_dict().items()},
            "last_obs": np_(sts.last_obs),
            "metrics": {k: float(v) for k, v in sm.items()}}
        if name == "hover-dyn-rpm":
            hover_single = (sinit, supdate)
    K4 = 4
    pinit, pupd, _, _ = make_train_population(
        matrix["hover-dyn-rpm"][0], HoverTask(act=ActionType.RPM,
                                              episode_len_sec=0.5),
        PPOConfig(num_envs=64, rollout_steps=24, num_minibatches=2,
                  update_epochs=2), K4, device=dev)
    pop_ref, pop_ref_m = pupd(pinit(torch.Generator(dev).manual_seed(SEED)))
    pop_ref_params = {k: np_(v) for k, v in
                      pop_ref.network.state_dict().items()}

    def close_np(a, b, tol):
        return float(np.abs(a - b).max()) if np.all(
            np.abs(a - b) <= tol[0] + tol[1] * np.abs(b)) else None

    def hold_leg(backend, ranks):
        """Every rank's sharded updates against the single-process ones,
        its kernel checks, the population against the unsharded one."""
        leg = {"matrix": {}}
        for name, (_, _, spp, spath, kernel) in matrix.items():
            ref = reference[name]
            recs = [r["matrix"][name] for r in ranks]
            steps = spp.update_epochs * spp.num_minibatches
            for r in recs:
                if r["env_path"] != spath or r["launches"] != {
                        kernel: spp.rollout_steps} \
                        or r["collectives"] != 3 * steps + 1:
                    raise AssertionError(
                        f"sharded {backend} {name}: path {r['env_path']}, "
                        f"launches {r['launches']}, collectives "
                        f"{r['collectives']}")
                for k, v in recs[0]["params"].items():
                    if not np.array_equal(r["params"][k], v):
                        raise AssertionError(f"sharded {backend} {name}: "
                                             f"{k} differs across ranks")
            param_err = max(float(np.abs(v - ref["params"][k]).max())
                            for k, v in recs[0]["params"].items())
            obs_err = close_np(recs[0]["last_obs"], ref["last_obs"],
                               (ATOL, 0.0))
            metric_err = {k: close_np(np.float64(v), ref["metrics"][k],
                                      PPO_METRIC_TOL)
                          for k, v in recs[0]["metrics"].items()}
            if param_err > PPO_PARAM_ATOL or obs_err is None \
                    or None in metric_err.values():
                raise AssertionError(
                    f"sharded {backend} {name}: weights {param_err}, last "
                    f"obs {obs_err}, metrics {metric_err} against one "
                    "process")
            leg["matrix"][name] = {
                "num_envs": spp.num_envs, "envs_a_rank":
                    spp.num_envs // SHARDED_RANKS,
                "rollout_steps": spp.rollout_steps, "env_path": spath,
                "launches_each_rank": recs[0]["launches"],
                "collectives_each_rank": recs[0]["collectives"],
                "param_max_abs_err": param_err,
                "last_obs_max_abs_err": obs_err,
                "metric_abs_err": metric_err,
                "rank_kernel_max_abs_err": [r["kernel_max_abs_err"]
                                            for r in recs],
                "rank_kernel_dw_ties": [r["kernel_dw_ties"] for r in recs]}
        pops = [r["population"] for r in ranks]
        pop_err = 0.0
        for r in pops:
            lo, hi = r["members"]
            if r["collectives"] != 0 or r["launches"] != {
                    "fused_env_step": 24}:
                raise AssertionError(f"sharded {backend} population: "
                                     f"{r['collectives']} collectives, "
                                     f"launches {r['launches']}")
            param_err = max(float(np.abs(v - pop_ref_params[k][lo:hi]).max())
                            for k, v in r["params"].items())
            errs = [close_np(r["last_obs"], np_(pop_ref.last_obs[lo:hi]),
                             (ATOL, 0.0))] + [
                close_np(v, np_(pop_ref_m[k][lo:hi]), PPO_METRIC_TOL)
                for k, v in r["metrics"].items()]
            if None in errs or param_err > PPO_PARAM_ATOL:
                raise AssertionError(f"sharded {backend} population: "
                                     f"members {lo}-{hi}: weights "
                                     f"{param_err}, obs and metrics {errs}")
            pop_err = max(pop_err, param_err, *errs)
        leg["population"] = {"members": K4, "ranks": SHARDED_RANKS,
                             "collectives": 0,
                             "launches_each_rank": pops[0]["launches"],
                             "max_abs_err": pop_err}
        return leg

    gloo = run_ranks(sharded_rank, SHARDED_RANKS, "gloo",
                     args=(list(matrix), SEED), timeout_s=900)
    sharded = {"phase": "sharded", "ranks": SHARDED_RANKS,
               "gloo": hold_leg("gloo", gloo)}
    # the checkpoint the ranks saved, resumed in this one process (R = 1):
    # the state the ranks gathered bit for bit, then the same update
    sinit, supdate = hover_single
    r1_ts = restore_ckpt(SHARDED_CKPT,
                         sinit(torch.Generator(dev).manual_seed(SEED + 2)))
    saved = gloo[0]["matrix"]["hover-dyn-rpm"]["saved"]
    if not (np.array_equal(np_(r1_ts.last_obs), saved["last_obs"]) and all(
            np.array_equal(np_(x), y)
            for x, y in zip(leaves(r1_ts.env_state), saved["env"]))):
        raise AssertionError("sharded checkpoint: R = 1 restores another "
                             "state than the ranks saved")
    r1_ts, om = supdate(r1_ts)
    resumed = gloo[0]["matrix"]["hover-dyn-rpm"]["resumed"]
    r1_err = max(float(np.abs(np_(v) - resumed["params"][k]).max())
                 for k, v in r1_ts.network.state_dict().items())
    r1_obs = close_np(np_(r1_ts.last_obs), resumed["last_obs"], (ATOL, 0.0))
    r1_metric = {k: close_np(np.float64(float(v)), resumed["metrics"][k],
                             PPO_METRIC_TOL) for k, v in om.items()}
    if r1_err > PPO_PARAM_ATOL or r1_obs is None \
            or None in r1_metric.values():
        raise AssertionError(f"sharded checkpoint: resumed at R = 1, the "
                             f"update is {r1_err} / {r1_obs} off R = 2's")
    sharded["checkpoint"] = {
        "saved_at": SHARDED_RANKS, "resumed_at": [SHARDED_RANKS, 1],
        "r2_resume_bitwise_equal": True, "r1_restore_bitwise_equal": True,
        "r1_vs_r2_update_param_max_abs_err": r1_err,
        "r1_vs_r2_last_obs_max_abs_err": r1_obs,
        "r1_vs_r2_metric_abs_err": r1_metric}
    if torch.cuda.device_count() >= 2:
        sharded["nccl"] = hold_leg("nccl", run_ranks(
            sharded_rank, SHARDED_RANKS, "nccl", args=(list(matrix), SEED),
            timeout_s=900))
    else:
        sharded["nccl"] = (f"not run: {torch.cuda.device_count()} card "
                           "visible")
    # the kernels at the ranks' shapes, timed here against their plain
    # versions (4096 hover envs a rank is hover4096's shape, timed above)
    env_case(Physics.PYB_GND_DRAG_DW, 2, False, True, P.CF2X, 1024,
             timed="sharded2_multihover2x1024", obstacles=())
    rcfg2, rtask2 = matrix["routing-pid"][:2]
    fused_case("sharded2_routing2x1024", rcfg2, rtask2, 1024)
    summary[("fused_env_step", "sharded2_hover4096")] = dict(
        summary[("fused_env_step", "hover4096")], timed_as="hover4096")
    sharded_counts = {}
    for name, config in (("hover-dyn-rpm", "sharded2_hover4096"),
                         ("multihover-pyb-gnd-drag-dw",
                          "sharded2_multihover2x1024"),
                         ("routing-pid", "sharded2_routing2x1024")):
        kernel = matrix[name][4]
        sharded_counts[config] = {kernel: sum(
            r["matrix"][name]["launches"][kernel] for r in gloo)}
        summary[(kernel, config)]["max_abs_err"] = max(
            summary[(kernel, config)]["max_abs_err"],
            *sharded["gloo"]["matrix"][name]["rank_kernel_max_abs_err"])
    sharded["launches"] = sharded_counts
    sharded["note"] = ("each rank a process on the card, gloo sharing it; "
                       "one sharded update of every matrix entry against "
                       "one process's, launches counted from 0 in each rank")
    emit(sharded)

    # ---- summary: one entry per kernel and main-path shape ----
    replaces = {
        "dyn_ctrl_step":
            "gym_pybullet_drones_tpu/ops/pallas_dyn.py:169",
        "pid_dyn_ctrl_step":
            "gym_pybullet_drones_tpu/ops/pallas_pid.py:182",
        "fused_env_step":
            "gym_pybullet_drones_tpu/ops/pallas_fused.py:230",
        "env_ctrl_step":
            "gym_pybullet_drones_tpu/ops/pallas_env.py:588",
        # no Pallas kernel: the JAX package's renderer is one XLA program
        "render": "gym_pybullet_drones_tpu/ops/render.py:100"}
    kernel_floors = {"dyn_ctrl_step": dyn_floors,
                     "pid_dyn_ctrl_step": pid_floors}
    kernels = []
    for config, counts in (("hover4096", hover_counts),
                           ("multihover2x8192", multi_counts),
                           ("routing4x4096", routing_counts),
                           ("routing4x4096_pyb", routing_pyb_counts),
                           ("routing4x16384_pyb", cell_counts),
                           ("hover4096_pyb_aero", hover_aero_counts),
                           ("ppo_hover8192", ppo_counts),
                           ("ppo_hover_pyb_learn", learn_counts),
                           ("ppo_population8x1024", pop_counts),
                           ("hover256_rgb", rgb_counts),
                           ("ppo_rgb512", rgb512_counts),
                           ("ppo_population_rgb8x512", prgb_counts),
                           *(("reset_noise_" + k, v)
                             for k, v in noise_counts.items()),
                           ("gym_adapter_images", adapter_counts),
                           ("swarm4096x4", swarm_counts),
                           ("routing3x128_pyb_learn", rr_learn_counts),
                           ("routing3x64_pyb_eval", rr_eval_counts),
                           *sharded_counts.items()):
        for name in counts:
            rec = summary[(name, config)]
            kernels.append({
                "name": name, "config": config, "route": "cuda",
                "source": "gym_pybullet_drones_tpu_torch/csrc/"
                          + _build.KERNELS[name][0],
                "replaces": replaces[name], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None, "blocks": rec["geometry"][0],
                "threads": rec["geometry"][1],
                **{k: ptxas.get(name, {}).get(k) for k in (
                    "registers", "stack_frame_bytes", "spill_store_bytes",
                    "spill_load_bytes")},
                **{k: rec[k] for k in ("resident_blocks_per_sm", "waves")
                   if k in rec}})
            if name in kernel_floors:
                kernels[-1].update(launch_floor_ms=launch_floor_ms,
                                   **kernel_floors[name])
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
