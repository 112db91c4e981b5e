"""CUDA kernel: the WHOLE env step in one launch — action mapping, action
history ring, physics, task reward/termination, auto-reset and observation
assembly — with the rollout carry held as ONE packed row block.

Replaces the TPU kernel `gym_pybullet_drones_tpu/ops/pallas_fused.py:
fused_env_step` (body `_kernel`) for every physics mode (`Physics.DYN` and
the PYB family) with every action type (RPM, ONE_D_RPM, and the PID family
PID / VEL / ONE_D_PID, whose embedded DSL-PID ticks in-kernel and carries 9
extra rows per drone) and the Hover / MultiHover / Routing tasks.  Source:
`csrc/fused_env_step.cu`, device functions in `csrc/drone_kernels.cuh`.

    carry (RC, B):  per drone [pos3 quat4 vel3 rpy_rates3 ang_v3]
                    [last_rpm4] [pid9, PID family only]
                    [action-history BUF*A rows]
                    then one global step-counter row (f32)
    outs  (RO, B):  per drone [obs12 + history + task extras] rows,
                    then reward / terminated / truncated rows

The row order equals the JAX package's carry, so a carry goes across
through `convert.py` as it is.  Rows are drone-major and the env index is
the contiguous one, so cross-drone task reductions (summed rewards,
any-drone truncation, routing's pairwise separation and nearest neighbour)
are plain per-thread arithmetic.  Auto-reset is a select against the reset
state passed in the parameter struct (deterministic resets only).

What bounds it on an H100: bytes — the carry rows the step needs are read
once (13 state rows per drone, the history rows that stay, the counter;
never last_rpm, ang_v or the dropped oldest action), every carry row is
written once, each action row read once, each output row written once, around
a few thousand float32 operations per env — and, at thousands of envs, the
launch overhead above both.  The design: one launch per control step, one
thread per (env, drone), 32 envs of N drones a block with warp w holding
drone w, so every row load and store of a warp is one 128-byte line and
4096 envs fill 128 blocks.  A drone's 16 state values stay in registers
through all substeps; its share of the task's sums and its stepped position
go to shared memory, where one thread per env adds them in drone order (the
order of a loop over drones, so the reward is the same float) and publishes
the done flag; each thread then selects the reset state for a done env and
writes its own drone's carry and observation rows.  The action-history ring
(60 rows for RPM at 30 Hz control) moves from the input to the output
blocks, its loads issued 16 at a time.  Routing's pairwise terms read the
positions shared by the env's other drones.  For the PID family the
per-drone chain grows by the PID tick (about 400 operations, with
divisions, square roots and inverse trig) before the substeps.  No lane
padding: the kernel takes B and the row stride and masks its tail (a thread
past B goes through every barrier and loads and stores nothing).  All
constants (drone, substeps, dt, action type, task, per-drone reset state
and targets, box limits, episode length) arrive in one by-value struct, so
one build serves every configuration.

Under the PYB family the physics is the coupled substep of
`ops/kernel_env.py` (device function `gpd_pyb_ctrl_substeps`, the same one
`csrc/env_ctrl_step.cu` calls): the drones of an env exchange their poses
through shared memory at a barrier per substep.  There the step also reads
the `last_rpm` rows (the stale drag of substep 0; zero after an auto-reset)
and the world `ang_v` rows, which are carried state; the `rpy_rates` rows
pass through.  What bounds that branch is operations, not bytes: around
3,000 per drone and substep, in one thread's dependent chain, whose
latency only more warps an SM hide: the kernel is built for at most 128
registers a thread, so that 4 blocks of the 4-drone fleet fit an SM and
16384 such fleets run in one wave (`launch_waves`).  It is a run-time
branch of the one kernel.  `cfg.solver_iterations` is a run-time
value of the struct: any sweep count `envs/core.step` takes runs here as
well.

`fused_env_step_plain` is the same row arithmetic in plain PyTorch.  The
wrapper uses it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

from typing import NamedTuple

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics
from gym_pybullet_drones_tpu_torch.utils.profiling import span
from gym_pybullet_drones_tpu_torch.params import CF2X
from gym_pybullet_drones_tpu_torch.ops import (
    kernel_dyn, kernel_env, kernel_math, kernel_pid)
from gym_pybullet_drones_tpu_torch.ops.kernel_dyn import check_rows

S = 16    # state rows per drone
LR = 4    # last-rpm rows per drone
PR = 9    # embedded-PID carry rows per drone (PID-family actions only)

PID_FAMILY = (ActionType.PID, ActionType.VEL, ActionType.ONE_D_PID)

# action-type ids of the kernel (GPD_ACT_* in csrc/drone_kernels.cuh)
_ACT_IDS = {ActionType.RPM: 0, ActionType.ONE_D_RPM: 1, ActionType.PID: 2,
            ActionType.VEL: 3, ActionType.ONE_D_PID: 4}

launches = 0  # kernel launches made by `fused_env_step` (CUDA only)


def _layout(n: int, buf_rows: int, act: ActionType = ActionType.RPM):
    """(rows per drone, carry rows RC) for `n` drones."""
    if act not in _ACT_IDS:
        raise ValueError(f"unsupported action type {act}")
    per_drone = S + LR + (PR if act in PID_FAMILY else 0) + buf_rows
    return per_drone, n * per_drone + 1          # + step-counter row


class PidSetpointConsts(NamedTuple):
    """How a PID-type action becomes a position setpoint; shared by
    `RLTask._pid_targets`, `pid_setpoint_rows` and the kernel's parameter
    struct."""

    step_size: float        # waypoint clamp (reference BaseRLAviary: 1.0)
    relative: bool          # action is a displacement, not a destination
    action_scale: float     # displacement per unit action when relative


def pid_setpoint_consts(task) -> PidSetpointConsts:
    """RoutingTask overrides these through its fields; the reference's RL
    aviaries use an absolute destination and a unit step."""
    step = float(getattr(task, "step_size", 1.0))
    return PidSetpointConsts(
        step, bool(getattr(task, "relative_actions", False)),
        float(getattr(task, "action_scale", step)))


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Everything constant over a rollout: what the TPU kernel folded into
    its program at trace time and this kernel takes as one struct."""

    cfg: object             # envs.core.AviaryConfig
    task: object            # a task with row_post / row_consts
    init16: tuple           # per drone, the 16 reset-state values

    def __post_init__(self):
        _layout(self.n, self.buf_rows, self.task.act)
        if not 1 <= self.n <= _build.MAX_DRONES:
            raise ValueError(
                f"the fused kernel takes 1..{_build.MAX_DRONES} drones")
        if len(self.cfg.obstacles) > kernel_env.MAX_OBSTACLES:
            raise ValueError(
                f"the fused kernel takes at most {kernel_env.MAX_OBSTACLES} "
                f"obstacles, got {len(self.cfg.obstacles)}")
        if len(self.init16) != self.n or \
                any(len(r) != S for r in self.init16):
            raise ValueError("init16 must hold 16 values per drone")

    @property
    def n(self) -> int:
        return self.cfg.num_drones

    @property
    def act_dim(self) -> int:
        return self.task.action_buffer_shape(self.cfg)[1]

    @property
    def buf_rows(self) -> int:
        buf_len, act_dim = self.task.action_buffer_shape(self.cfg)
        return buf_len * act_dim

    @property
    def carry_rows(self) -> int:
        return _layout(self.n, self.buf_rows, self.task.act)[1]

    @property
    def n_extra(self) -> int:
        """Task-specific obs rows per drone (`row_extra_obs`)."""
        if getattr(self.task, "row_extra_obs", None) is None:
            return 0
        return self.task.n_extra_obs_rows

    @property
    def obs_rows_per(self) -> int:
        return 12 + self.buf_rows + self.n_extra

    @property
    def out_rows(self) -> int:
        return self.n * self.obs_rows_per + 3


@functools.lru_cache(maxsize=32)
def _step_params(spec: FusedSpec) -> _build.StepParams:
    cfg, task = spec.cfg, spec.task
    rc = task.row_consts(cfg)
    sp = _build.StepParams()
    kernel_dyn.fill_drone_params(sp, cfg.drone, cfg.steps_per_ctrl,
                                 cfg.pyb_dt)
    # the embedded controller is always CF2X (reference BaseRLAviary.py:76)
    kernel_pid.fill_pid_params(sp, CF2X, cfg.ctrl_dt)
    kernel_env.fill_pyb_params(sp, cfg.drone, cfg.physics, cfg.pyb_dt,
                               cfg.obstacles, cfg.solver_iterations)
    sp.n_drones, sp.act_dim, sp.buf_rows = spec.n, spec.act_dim, spec.buf_rows
    sp.act_type, sp.task_id = _ACT_IDS[task.act], rc.task_id
    sp.n_extra = spec.n_extra
    sp.pyb_freq, sp.episode_len_sec = cfg.pyb_freq, rc.episode_len_sec
    sp.box_xy, sp.box_z, sp.tilt = rc.box_xy, rc.box_z, rc.tilt
    pc = pid_setpoint_consts(task)
    sp.speed_limit = cfg.drone.speed_limit
    sp.step_size, sp.action_scale = pc.step_size, pc.action_scale
    sp.relative_actions = int(pc.relative)
    sp.shaped, sp.arrival_tol = int(rc.shaped), rc.arrival_tol
    sp.collision_r2 = rc.collision_radius * rc.collision_radius
    sp.progress_gain, sp.arrival_hold = rc.progress_gain, rc.arrival_hold
    for d in range(spec.n):
        for k in range(S):
            sp.init16[d][k] = spec.init16[d][k]
    for d, tgt in enumerate(rc.targets):
        for k in range(3):
            sp.target[d][k] = tgt[k]
    return sp


def pid_setpoint_rows(cfg, task, st, a):
    """The embedded PID's 12 setpoint rows (target pos, rpy, vel, rpy
    rates) from one drone's PRE-step state rows and RAW action rows, per
    `RLTask._pid_targets`; mirrors `gpd_pid_setpoints`."""
    p, q = st[0:3], st[3:7]
    zero = p[0] * 0.0
    if task.act == ActionType.PID:
        # waypoint clamp (core.next_waypoint; reference
        # BaseAviary._calculateNextStep :1105-1147)
        c = pid_setpoint_consts(task)
        dest = [p[k] + c.action_scale * a[k] for k in range(3)] \
            if c.relative else list(a[0:3])
        dx = [dest[k] - p[k] for k in range(3)]
        dist = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
        safe = torch.where(dist > 0.0, dist, 1.0)
        tp = [torch.where(dist <= c.step_size, dest[k],
                          p[k] + dx[k] / safe * c.step_size)
              for k in range(3)]
        return tp + [zero] * 9
    if task.act == ActionType.VEL:
        vx, vy, vz, sf = a
        norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
        inv = torch.where(norm > 0.0,
                          1.0 / torch.where(norm > 0.0, norm, 1.0), 0.0)
        mag = cfg.drone.speed_limit * torch.abs(sf) * inv
        _, _, yaw = kernel_math.quat_rpy_rows(*q)
        return (list(p) + [zero, zero, yaw]
                + [mag * vx, mag * vy, mag * vz] + [zero] * 3)
    # ONE_D_PID: a height offset
    return [p[0], p[1], p[2] + 0.1 * a[0]] + [zero] * 9


def fused_env_step_plain(spec: FusedSpec, carry: torch.Tensor,
                         action_rows: torch.Tensor):
    """Plain PyTorch version of the kernel: carry (RC, B), action rows
    (N*A, B) -> (carry' (RC, B), outs (RO, B))."""
    cfg, task, n = spec.cfg, spec.task, spec.n
    params, act, act_dim, buf_rows = cfg.drone, task.act, spec.act_dim, \
        spec.buf_rows
    per_drone, _ = _layout(n, buf_rows, act)
    hover = params.hover_rpm
    has_pid = act in PID_FAMILY
    pid_off = S + LR
    buf_off = pid_off + (PR if has_pid else 0)

    # ---- action mapping + buffer shift + physics ----
    pyb = cfg.physics != Physics.DYN
    stepped, new_bufs, new_pids, rpms, lasts = [], [], [], [], []
    for d in range(n):
        base = d * per_drone
        st = [carry[base + k] for k in range(S if pyb else 13)]
        a = action_rows[d * act_dim:(d + 1) * act_dim]
        if act == ActionType.RPM:
            rpm = [hover * (1.0 + 0.05 * a[k]) for k in range(4)]
        elif act == ActionType.ONE_D_RPM:  # one action over the four motors
            rpm = [hover * (1.0 + 0.05 * a[0])] * 4
        else:
            # embedded DSL-PID tick, always the CF2X controller; the ring
            # below stores the RAW action
            rpm, new_pid = kernel_pid.pid_tick_rows(
                CF2X, cfg.ctrl_dt, st,
                tuple(carry[base + pid_off:base + pid_off + PR]),
                pid_setpoint_rows(cfg, task, st, a))
            new_pids.append(new_pid)
        rpms.append(rpm)
        # history ring: oldest first (reference BaseRLAviary.py:66-67)
        buf = carry[base + buf_off:base + buf_off + buf_rows]
        new_bufs.append(torch.cat([buf[act_dim:], a]) if buf_rows else buf)
        if pyb:
            # PYB family: coupled, stepped below once every drone has rpm
            stepped.append(st)
            lasts.append(list(carry[base + S:base + S + LR]))
            continue
        thrust, xt, yt, zt = kernel_dyn.motor_mix_rows(params, *rpm)
        stepped.append(kernel_dyn.dyn_substeps_rows(
            params, cfg.steps_per_ctrl, cfg.pyb_dt, tuple(st),
            thrust, xt, yt, zt))
    if pyb:
        stepped = kernel_env.pyb_ctrl_step_rows(
            params, cfg.physics, cfg.steps_per_ctrl, cfg.pyb_dt,
            cfg.obstacles, stepped, rpms, lasts, cfg.solver_iterations)

    # ---- task post on the stepped rows ----
    sc_row = carry[n * per_drone]
    sc_new = sc_row + float(cfg.steps_per_ctrl)
    dinfo = []
    for o in stepped:
        dinfo.append({"p": o[0:3], "rpy": kernel_math.quat_rpy_rows(*o[3:7]),
                      "v": o[7:10], "w": o[13:16]})
    # row_post sees the PRE-increment substep counter: the reference advances
    # step_counter only after the termination hooks (BaseAviary.py:376-382)
    reward, term, trunc = task.row_post(cfg, dinfo, sc_row)
    done = term | trunc

    # ---- auto-reset select: every carry row of a done env ----
    carry_out = torch.empty_like(carry)
    outs = torch.empty((spec.out_rows, carry.shape[1]), dtype=carry.dtype,
                       device=carry.device)
    obs_rows_per = spec.obs_rows_per
    sel_dinfo = []
    for d in range(n):
        base, ob = d * per_drone, d * obs_rows_per
        for k in range(S):
            carry_out[base + k] = torch.where(done, spec.init16[d][k],
                                              stepped[d][k])
        for k in range(LR):
            carry_out[base + S + k] = torch.where(done, 0.0, rpms[d][k])
        if has_pid:
            for k in range(PR):
                carry_out[base + pid_off + k] = torch.where(
                    done, 0.0, new_pids[d][k])
        if buf_rows:
            carry_out[base + buf_off:base + buf_off + buf_rows] = \
                torch.where(done, 0.0, new_bufs[d])
        # ---- observation rows from the SELECTED (post-reset) state ----
        sel = carry_out[base:base + S]
        roll, pitch, yaw = kernel_math.quat_rpy_rows(*sel[3:7])
        outs[ob:ob + 3] = sel[0:3]
        outs[ob + 3], outs[ob + 4], outs[ob + 5] = roll, pitch, yaw
        outs[ob + 6:ob + 9] = sel[7:10]
        outs[ob + 9:ob + 12] = sel[13:16]
        outs[ob + 12:ob + 12 + buf_rows] = \
            carry_out[base + buf_off:base + buf_off + buf_rows]
        sel_dinfo.append({"p": list(sel[0:3]), "rpy": (roll, pitch, yaw),
                          "v": list(sel[7:10]), "w": list(sel[13:16])})
    if spec.n_extra:
        # task extras (routing: goal vector, nearest neighbour) see the
        # selected positions of ALL drones
        for d, rows in enumerate(task.row_extra_obs(cfg, sel_dinfo)):
            ob = d * obs_rows_per + 12 + buf_rows
            for k, row in enumerate(rows):
                outs[ob + k] = row
    carry_out[n * per_drone] = torch.where(done, 0.0, sc_new)
    ro = n * obs_rows_per
    outs[ro] = reward
    outs[ro + 1] = term.to(carry.dtype)
    outs[ro + 2] = trunc.to(carry.dtype)
    return carry_out, outs


@functools.lru_cache(maxsize=64)
def launch_waves(b: int, n: int, pyb: bool, device: torch.device) -> float:
    """Waves of the kernel's launch over `b` envs of `n` drones on the
    CUDA `device`: its blocks over the blocks that all SMs hold at once
    (the kernel's resident blocks an SM, `_build.resident_blocks`, times
    the SMs).  At most 1 means every block runs in the first wave.
    Computed once a shape and device."""
    blocks, _ = _build.launch_geometry("fused_env_step", b, n)
    with torch.cuda.device(device):
        per_sm = _build.resident_blocks("fused_env_step", n, pyb)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks / (per_sm * sms)


def fused_env_step(spec: FusedSpec, carry: torch.Tensor,
                   action_rows: torch.Tensor):
    """The kernel's wrapper: one fully-fused control step.

    carry: (RC, B) float32 row block (see the module docstring);
    action_rows: (N*A, B), drone-major.  Returns (carry', outs (RO, B)).
    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation; outputs from `torch.empty`); a CPU tensor runs
    `fused_env_step_plain`.  Anything the kernel does not take raises.
    The whole call, the CPU path included, is the span
    `kernel.fused_env_step` (`utils.profiling.span`); a launch gives it
    the attribute `waves` (`launch_waves`) where the span is on.
    """
    global launches
    with span("kernel.fused_env_step") as sp:
        check_rows("carry", carry, spec.carry_rows)
        check_rows("action_rows", action_rows, spec.n * spec.act_dim,
                   like=carry)
        if carry.device.type == "cpu":
            return fused_env_step_plain(spec, carry, action_rows)
        if carry.device.type != "cuda":
            raise ValueError(f"unsupported device {carry.device}")
        fn = _build.load()["fused_env_step"]
        b = carry.shape[1]
        carry_out = torch.empty_like(carry)
        outs = torch.empty((spec.out_rows, b), dtype=torch.float32,
                           device=carry.device)
        with torch.cuda.device(carry.device):
            err = fn(carry.data_ptr(), action_rows.data_ptr(),
                     carry_out.data_ptr(), outs.data_ptr(), b,
                     carry.stride(0), ctypes.byref(_step_params(spec)),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"fused_env_step launch failed: CUDA error {err}")
        launches += 1
        if sp is not None:
            sp.attrs["waves"] = launch_waves(
                b, spec.n, spec.cfg.physics != Physics.DYN, carry.device)
        return carry_out, outs


def pack_carry(state_leaves: dict, n: int, buf_rows: int, b: int,
               act: ActionType = ActionType.RPM, device=None) -> torch.Tensor:
    """numpy EnvState-like leaves (flattened (B*N, k), env-major) ->
    (RC, B) drone-major row block on `device` (None = the CUDA card; no
    lane padding)."""
    device = resolve_device(device)
    per_drone, rc = _layout(n, buf_rows, act)
    # (B*N, 9) [last_rpy | integral_pos_e | integral_rpy_e], zeros if absent
    pid = state_leaves.get("pid") if act in PID_FAMILY else None
    buf_off = S + LR + (PR if act in PID_FAMILY else 0)
    blk = np.zeros((rc, b), np.float32)
    flat16 = np.concatenate(
        [state_leaves["pos"], state_leaves["quat"], state_leaves["vel"],
         state_leaves["rpy_rates"], state_leaves["ang_v"]], axis=-1)
    for d in range(n):
        base = d * per_drone
        blk[base:base + S] = flat16[d::n].T            # (16, B)
        blk[base + S:base + S + LR] = state_leaves["last_rpm"][d::n].T
        if pid is not None:
            blk[base + S + LR:base + S + LR + PR] = pid[d::n].T
        if buf_rows:
            blk[base + buf_off:base + buf_off + buf_rows] = \
                state_leaves["action_buffer"][d::n].reshape(b, buf_rows).T
    blk[n * per_drone] = np.asarray(state_leaves["step_counter"], np.float32)
    return torch.from_numpy(blk).to(device)


def unpack_carry(carry: torch.Tensor, n: int, buf_rows: int,
                 act: ActionType = ActionType.RPM) -> dict:
    """(RC, B) drone-major row block -> flattened env-major leaves
    {name: (B*N, k) tensor}, the inverse of `pack_carry` on the carry's own
    device: pos, quat, vel, rpy_rates, ang_v, last_rpm, pid (PID family
    only), action_buffer (B*N, BUF*A) and step_counter (B,) float."""
    per_drone, rc = _layout(n, buf_rows, act)
    check_rows("carry", carry, rc)
    b = carry.shape[1]
    flat = carry[:n * per_drone].reshape(n, per_drone, b).permute(2, 0, 1) \
        .reshape(b * n, per_drone)
    cuts = [("pos", 3), ("quat", 4), ("vel", 3), ("rpy_rates", 3),
            ("ang_v", 3), ("last_rpm", LR)]
    if act in PID_FAMILY:
        cuts.append(("pid", PR))
    cuts.append(("action_buffer", buf_rows))
    leaves, col = {}, 0
    for name, width in cuts:
        leaves[name] = flat[:, col:col + width]
        col += width
    leaves["step_counter"] = carry[n * per_drone]
    return leaves


def unpack_outs(outs: torch.Tensor, n: int, buf_rows: int,
                obs_layout: str = "flat", n_extra: int = 0):
    """(RO, B) outputs -> (obs, reward (B,), term (B,) bool, trunc).

    obs_layout "rows" returns the (N*D, B) row block as it is; "flat" and
    "drone" return transposed VIEWS of it, (B, N*D) and (B, N, D): no copy
    is made per step.
    """
    obs_rows_per = 12 + buf_rows + n_extra
    ro = n * obs_rows_per
    obs = outs[:ro]                                    # (N*D, B)
    if obs_layout != "rows":
        obs = obs.t()                                  # (B, N*D)
        if obs_layout == "drone":
            obs = obs.unflatten(1, (n, obs_rows_per))
    return obs, outs[ro], outs[ro + 1] > 0.5, outs[ro + 2] > 0.5
