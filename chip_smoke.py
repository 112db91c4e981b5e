#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Builds the hand-written CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, and drives the
port's main path — the batched DYN rollout of HoverTask (4096 envs) and
MultiHoverTask (2 drones, 8192 envs) through `make_fused_rollout` and
`make_batched_step` — checking what comes out.  Any failed phase raises and
the process exits non-zero.  It imports only torch, numpy and the port.

Output: one JSON object per line, in order `env`, `build`,
`kernel_checks`, `rollout_hover`, `rollout_multihover`, `timing`, then the
`{"kernels": [...]}` summary (one entry per kernel and main-path shape),
then the card's name and power limit as nvidia-smi prints them, then
`{"ok": true, "device": {...}}` as the last line.
"""
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ATOL, RTOL = 2e-5, 1e-4     # kernel vs plain version, state and obs
FLAG_MARGIN = 1e-5          # a flag may differ only this close to a tie
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def ops_per_column(n_substeps, n_drones=1, euler_calls=1):
    """Float32 operations one column of work needs, counted from the
    device functions: mixer 30, one substep 175 (rotation 53, forces and
    torques 25, integration 27, exponential map 55 with sqrt/sin/cos/div
    as one each, ang-vel 15), one Euler extraction 40, task and select 40
    per drone."""
    return n_drones * (30 + 175 * n_substeps + 40 * euler_calls + 40)


def bound_ms(rows, b, ops):
    """Least time the card could take: every row the function needs read
    once, every output row written once, against its float32 operations.
    `rows` counts what the function uses, not what its blocks hold: the
    world ang-vel rows of the input state are recomputed, never read."""
    t_bytes = rows * 4 * b / HBM_BYTES_PER_S * 1e3
    t_ops = ops * b / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def check_close(name, got, ref, cols=None):
    """Max abs error of `got` against `ref`; raises beyond ATOL/RTOL."""
    if cols is not None:
        got, ref = got[:, cols], ref[:, cols]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > ATOL + RTOL * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} values beyond atol {ATOL} rtol "
            f"{RTOL}, max abs err {float(err.max())}")
    return float(err.max())


def rand_state_rows(rng, b):
    """(16, b) float32 state rows around a hover, from numpy."""
    pos = rng.normal(size=(3, b)) * 0.3 + np.array([[0.0], [0.0], [1.0]])
    quat = rng.normal(size=(4, b)) * 0.1 + np.array([[0.0]] * 3 + [[1.0]])
    quat /= np.linalg.norm(quat, axis=0, keepdims=True)
    vel = rng.normal(size=(3, b)) * 0.3
    rates = rng.normal(size=(3, b))
    ang_v = rng.normal(size=(3, b))
    return np.concatenate([pos, quat, vel, rates, ang_v]).astype(np.float32)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    from gym_pybullet_drones_tpu_torch import _build, params as P
    from gym_pybullet_drones_tpu_torch.envs import (
        AviaryConfig, HoverTask, MultiHoverTask, fused_spec,
        make_batched_step, make_fused_rollout)
    from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_fused
    from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics

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
    emit({"phase": "build", "seconds": round(_build.build_seconds, 3),
          "sources": sorted(src for src, _ in _build.KERNELS.values()),
          "ptxas": {name: [line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line]
                    for name, log in _build.build_log.items()}})

    def hover_cfg(n=1):
        return AviaryConfig(P.CF2X, n, Physics.DYN, 240, 30)
    DT, SUB = 1 / 240, 8

    # ---- kernels against their plain versions, on the card ----
    rng = np.random.default_rng(SEED)
    checks, summary = [], {}

    def dyn_case(model, b, emit_obs12, timed=None):
        s = rand_state_rows(rng, b)
        s[10:13, :4] = 0.0                       # zero rates: keep branch
        rpm = model.hover_rpm * (1 + 0.02 * rng.normal(size=(4, b)))
        rpm[:, :4] = model.hover_rpm             # and no torque
        s = torch.from_numpy(s).to(dev)
        rpm = torch.from_numpy(rpm.astype(np.float32)).to(dev)
        run = lambda: kernel_dyn.dyn_ctrl_step_rows(model, s, rpm, SUB, DT,
                                                    emit_obs12)
        plain = lambda: kernel_dyn.dyn_ctrl_step_plain(model, s, rpm, SUB,
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
                                 "rates")
        rec = {"kernel": "dyn_ctrl_step", "model": model.model.value, "B": b,
               "emit_obs12": emit_obs12, "max_abs_err": err}
        if timed:
            # 13 state rows (no ang-vel) and 4 rpm rows in, 16 (+12) out
            rows = 13 + 4 + 16 + (12 if emit_obs12 else 0)
            bms, by = bound_ms(rows, b, ops_per_column(SUB))
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

    def flag_margin(spec, carry, a_rows):
        """Per env, how close the nearest deciding quantity of the task's
        flags lies to its threshold, from the plain stepped state."""
        cfg, task, n, A = spec.cfg, spec.task, spec.n, spec.act_dim
        rc = task.row_consts(cfg)
        per = (spec.carry_rows - 1) // n
        margins, dist_sum = [], 0.0
        for d, tgt in enumerate(rc.targets):
            a = a_rows[d * A:(d + 1) * A]
            rpm = (cfg.drone.hover_rpm * (1.0 + 0.05 * a)).expand(4, -1)
            _, o = kernel_dyn.dyn_ctrl_step_plain(
                cfg.drone, carry[d * per:d * per + 16].contiguous(),
                rpm.contiguous(), SUB, DT, True)
            margins += [(o[0].abs() - rc.box_xy).abs(),
                        (o[1].abs() - rc.box_xy).abs(),
                        (o[2] - rc.box_z).abs(), (o[3].abs() - rc.tilt).abs(),
                        (o[4].abs() - rc.tilt).abs()]
            dist_sum = dist_sum + torch.sqrt(
                (tgt[0] - o[0]) ** 2 + (tgt[1] - o[1]) ** 2
                + (tgt[2] - o[2]) ** 2)
        margins.append((dist_sum - 1e-4).abs())
        margins.append((carry[-1] / cfg.pyb_freq - rc.episode_len_sec).abs())
        return torch.stack(margins).min(dim=0).values

    def fused_case(name, cfg, task, b):
        spec = fused_spec(cfg, task)
        n, A = spec.n, spec.act_dim
        per = (spec.carry_rows - 1) // n
        # a mid-episode carry: random state, rpm and history; counters up
        # to past the episode's end, so that some envs truncate
        c = rng.normal(size=(spec.carry_rows, b)).astype(np.float32)
        for d in range(n):
            c[d * per:d * per + 16] = rand_state_rows(rng, b)
            c[d * per + 16:d * per + 20] = cfg.drone.hover_rpm * (
                1 + 0.02 * rng.normal(size=(4, b)))
        c[-1] = 8.0 * rng.integers(0, 246, size=b)
        carry = torch.from_numpy(c).to(dev)
        act = torch.from_numpy(
            (0.3 * rng.normal(size=(n * A, b))).astype(np.float32)).to(dev)
        run = lambda: kernel_fused.fused_env_step(spec, carry, act)
        plain = lambda: kernel_fused.fused_env_step_plain(spec, carry, act)
        (gc, go), (rc_, ro) = run(), plain()
        torch.cuda.synchronize()
        flags_differ = (go[-2:] != ro[-2:]).any(dim=0)
        margin = flag_margin(spec, carry, act)
        if (flags_differ & (margin > FLAG_MARGIN)).any():
            raise AssertionError(f"{name}: flags differ away from a tie")
        same = ~flags_differ
        err = max(check_close(f"{name} carry", gc, rc_, same),
                  check_close(f"{name} outs", go, ro, same))
        done = (ro[-2:] > 0.5).any(dim=0)
        if not (done.any() and (~done).any()):
            raise AssertionError(f"{name}: the case must mix done and "
                                 "running envs")
        # in: per drone 13 state rows and the ring without the A rows it
        # drops (last_rpm and ang-vel are never read), the counter row and
        # the action rows; out: the whole carry and the outputs
        rows = n * (13 + spec.buf_rows - A) + 1 + n * A \
            + spec.carry_rows + spec.out_rows
        bms, by = bound_ms(rows, b, ops_per_column(SUB, n, euler_calls=2))
        rec = {"kernel": "fused_env_step", "config": name, "B": b,
               "rows": [spec.carry_rows, spec.out_rows],
               "max_abs_err": err, "flag_ties": int(flags_differ.sum()),
               "done_share": float(done.float().mean()),
               "ms": graph_ms(run), "eager_ms": eager_ms(run, 200),
               "plain_ms": eager_ms(plain, 5, 1), "bound_ms": bms,
               "bound_by": by}
        checks.append(rec)
        summary[("fused_env_step", name)] = rec

    fused_case("hover4096", hover_cfg(), HoverTask(act=ActionType.RPM), 4096)
    fused_case("hover4096_one_d_rpm", hover_cfg(),
               HoverTask(act=ActionType.ONE_D_RPM), 4096)
    fused_case("multihover2x8192", hover_cfg(2),
               MultiHoverTask(act=ActionType.RPM), 8192)
    emit({"phase": "kernel_checks", "atol": ATOL, "rtol": RTOL,
          "cases": checks})

    # ---- the main path ----
    def random_rollout(name, cfg, task, b, steps, compare_steps=32):
        """`steps` control steps of 0.1*N(0,1) actions through the fused
        path, then the first `compare_steps` again through the batched
        path (kernel 1) from the same start."""
        n = cfg.num_drones
        acts = torch.from_numpy(
            (0.1 * np.random.default_rng(SEED + 1).normal(
                size=(steps, b, n, 4))).astype(np.float32)).to(dev)
        reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
        carry, obs = reset_fn()
        before = kernel_fused.launches
        chk = torch.zeros((), device=dev)
        n_done = torch.zeros((), device=dev)
        kept = []
        for t in range(steps):
            carry, obs, reward, term, trunc = step_fn(carry, acts[t])
            chk = chk + obs.sum() + reward.sum()
            n_done = n_done + (term | trunc).sum()
            if t < compare_steps:
                kept.append((obs, reward, term, trunc))
        torch.cuda.synchronize()
        if obs.shape != (b, n * 72) or reward.shape != (b,):
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
        before = kernel_dyn.launches
        err = 0.0
        for t in range(compare_steps):
            state, bo, br, bte, btr = b_step(state, acts[t])
            fo, fr, fte, ftr = kept[t]
            if not (torch.equal(bte, fte) and torch.equal(btr, ftr)):
                raise AssertionError(f"{name}: flags differ between the "
                                     f"fused and batched paths at step {t}")
            err = max(err, check_close(f"{name} obs t={t}", bo, fo),
                      check_close(f"{name} reward t={t}", br[None],
                                  fr[None]))
        if kernel_dyn.launches - before != compare_steps:
            raise AssertionError(f"{name}: batched path launch count")
        return {"steps": steps, "envs": b, "resets": int(n_done),
                "fused_vs_batched_steps": compare_steps,
                "fused_vs_batched_max_abs_err": err}

    # rollout_hover
    kernel_dyn.launches = kernel_fused.launches = 0
    cfg, task, b = hover_cfg(), HoverTask(act=ActionType.RPM), 4096
    reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
    carry, obs = reset_fn()
    zero = torch.zeros((b, 1, 4), device=dev)
    ident = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)[:, None]
    symmetric = torch.ones((), dtype=torch.bool, device=dev)
    all_tr, any_tr, any_te = [], [], []
    for t in range(300):
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
             "bitwise_symmetric": True}
    hover.update(random_rollout("hover4096", cfg, task, b, 512))
    hover_counts = {"fused_env_step": kernel_fused.launches,
                    "dyn_ctrl_step": kernel_dyn.launches}
    hover["launches"] = hover_counts
    emit(hover)

    # rollout_multihover
    kernel_dyn.launches = kernel_fused.launches = 0
    mcfg, mtask, mb = hover_cfg(2), MultiHoverTask(act=ActionType.RPM), 8192
    multi = {"phase": "rollout_multihover"}
    multi.update(random_rollout("multihover2x8192", mcfg, mtask, mb, 128))
    multi_counts = {"fused_env_step": kernel_fused.launches,
                    "dyn_ctrl_step": kernel_dyn.launches}
    multi["launches"] = multi_counts
    emit(multi)
    for counts in (hover_counts, multi_counts):
        if min(counts.values()) == 0:
            raise AssertionError(f"a kernel was never launched: {counts}")

    # ---- timing: env-steps/s, host readback inside the window ----
    def steps_per_s(cfg, task, b, steps):
        acts = 0.1 * torch.randn((steps, b, cfg.num_drones, 4), device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     SEED))
        reset_fn, step_fn = make_fused_rollout(cfg, task, b, device=dev)
        best_dt = float("inf")
        for _ in range(3):
            carry, _ = reset_fn()
            total = torch.zeros((), device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(steps):
                carry, _, reward, _, _ = step_fn(carry, acts[t])
                total = total + reward.sum()
            torch.cuda.synchronize()
            readback = float(total)
            dt = time.perf_counter() - t0
            if not np.isfinite(readback):
                raise AssertionError("timing: non-finite reward sum")
            best_dt = min(best_dt, dt)
        return steps * b / best_dt, best_dt / steps * 1e3

    hover_rate, hover_step_ms = steps_per_s(cfg, task, b, 512)
    multi_rate, multi_step_ms = steps_per_s(mcfg, mtask, mb, 128)
    emit({"phase": "timing", "gpu": card,
          "hover4096_env_steps_per_s": hover_rate,
          "hover4096_wall_ms_per_step": hover_step_ms,
          "multihover2x8192_env_steps_per_s": multi_rate,
          "multihover2x8192_wall_ms_per_step": multi_step_ms,
          "note": "best of 3; python loop, one launch per control step; "
                  "wall_ms_per_step is host time per control step, to set "
                  "against the kernel's device ms"})

    # ---- summary: one entry per kernel and main-path shape ----
    replaces = {
        "dyn_ctrl_step":
            "gym_pybullet_drones_tpu/ops/pallas_dyn.py:169",
        "fused_env_step":
            "gym_pybullet_drones_tpu/ops/pallas_fused.py:230"}
    kernels = []
    for config, counts in (("hover4096", hover_counts),
                           ("multihover2x8192", multi_counts)):
        for name in ("dyn_ctrl_step", "fused_env_step"):
            rec = summary[(name, config)]
            kernels.append({
                "name": name, "config": config, "route": "cuda",
                "source": "gym_pybullet_drones_tpu_torch/csrc/"
                          + _build.KERNELS[name][0],
                "replaces": replaces[name], "launches": counts[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
