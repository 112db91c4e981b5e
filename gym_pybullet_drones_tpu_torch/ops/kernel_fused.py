"""CUDA kernel: the WHOLE env step in one launch — action mapping, action
history ring, physics, task reward/termination, auto-reset and observation
assembly — with the rollout carry held as ONE packed row block.

Replaces the TPU kernel `gym_pybullet_drones_tpu/ops/pallas_fused.py:
fused_env_step` (body `_kernel`) for `Physics.DYN` with RPM / ONE_D_RPM
actions and the Hover / MultiHover tasks.  Source:
`csrc/fused_env_step.cu`, device functions in `csrc/drone_kernels.cuh`.
Its PID-family specialisation (9 extra carry rows per drone) and its PYB
physics specialisation are still to port (ROADMAP.md queue 2, K2 (c), (d)).

    carry (RC, B):  per drone [pos3 quat4 vel3 rpy_rates3 ang_v3]
                    [last_rpm4] [action-history BUF*A rows]
                    then one global step-counter row (f32)
    outs  (RO, B):  per drone [obs12 + history] rows,
                    then reward / terminated / truncated rows

Rows are drone-major and the env index is the contiguous one, so
cross-drone task reductions (summed rewards, any-drone truncation) are
plain per-thread arithmetic.  Auto-reset is a select against the reset
state passed in the parameter struct (deterministic resets only).

What bounds it on an H100: bytes — the carry rows the step needs are read
once (13 state rows per drone, the history rows that stay, the counter;
never last_rpm, ang_v or the dropped oldest action), every carry row is
written once, each action row read once, each output row written once, around
a few thousand float32 operations per env — and, at thousands of envs, the
launch overhead above both.  The design: one launch per control step, one
thread per env, a drone's 16 state values in registers through all
substeps, every load and store coalesced.  The action-history ring (60
rows for RPM at 30 Hz control) moves through memory row by row and never
through registers.  The drones of an env are stepped one after the other;
their stepped state waits in the output block (the thread re-reads its own
column) until the env's done flag is known.  No lane padding, no blocking:
the kernel takes B and the row stride and masks its tail.  All constants
(drone, substeps, dt, action type, task, per-drone reset state and
targets, box limits, episode length) arrive in one by-value struct, so one
build serves every configuration.

`fused_env_step_plain` is the same row arithmetic in plain PyTorch.  The
wrapper uses it only for tensors that lie on the CPU; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_math
from gym_pybullet_drones_tpu_torch.ops.kernel_dyn import check_rows

S = 16    # state rows per drone
LR = 4    # last-rpm rows per drone

# action-type ids of the kernel (GPD_ACT_* in csrc/drone_kernels.cuh)
_ACT_IDS = {ActionType.RPM: 0, ActionType.ONE_D_RPM: 1}

launches = 0  # kernel launches made by `fused_env_step` (CUDA only)


def _layout(n: int, buf_rows: int, act: ActionType = ActionType.RPM):
    """(rows per drone, carry rows RC) for `n` drones."""
    if act not in _ACT_IDS:
        raise NotImplementedError(
            f"{act}: the PID-family carry rows are ROADMAP.md queue 2, "
            "K2 (c)")
    per_drone = S + LR + buf_rows
    return per_drone, n * per_drone + 1          # + step-counter row


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Everything constant over a rollout: what the TPU kernel folded into
    its program at trace time and this kernel takes as one struct."""

    cfg: object             # envs.core.AviaryConfig
    task: object            # a task with row_post / row_consts
    init16: tuple           # per drone, the 16 reset-state values

    def __post_init__(self):
        cfg, task = self.cfg, self.task
        if cfg.physics != Physics.DYN:
            raise NotImplementedError(
                f"{cfg.physics}: the fused kernel's PYB branch is "
                "ROADMAP.md queue 2, K2 (d)")
        _layout(self.n, self.buf_rows, task.act)
        if not 1 <= self.n <= _build.MAX_DRONES:
            raise ValueError(
                f"the fused kernel takes 1..{_build.MAX_DRONES} drones")
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
    def obs_rows_per(self) -> int:
        return 12 + self.buf_rows

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
    sp.n_drones, sp.act_dim, sp.buf_rows = spec.n, spec.act_dim, spec.buf_rows
    sp.act_type, sp.task_id = _ACT_IDS[task.act], rc.task_id
    sp.pyb_freq, sp.episode_len_sec = cfg.pyb_freq, rc.episode_len_sec
    sp.box_xy, sp.box_z, sp.tilt = rc.box_xy, rc.box_z, rc.tilt
    for d in range(spec.n):
        for k in range(S):
            sp.init16[d][k] = spec.init16[d][k]
    for d, tgt in enumerate(rc.targets):
        for k in range(3):
            sp.target[d][k] = tgt[k]
    return sp


def fused_env_step_plain(spec: FusedSpec, carry: torch.Tensor,
                         action_rows: torch.Tensor):
    """Plain PyTorch version of the kernel: carry (RC, B), action rows
    (N*A, B) -> (carry' (RC, B), outs (RO, B))."""
    cfg, task, n = spec.cfg, spec.task, spec.n
    params, act, act_dim, buf_rows = cfg.drone, task.act, spec.act_dim, \
        spec.buf_rows
    per_drone, _ = _layout(n, buf_rows, act)
    hover = params.hover_rpm
    buf_off = S + LR

    # ---- action mapping + buffer shift + physics ----
    stepped, new_bufs, rpms = [], [], []
    for d in range(n):
        base = d * per_drone
        st = [carry[base + k] for k in range(13)]
        a = action_rows[d * act_dim:(d + 1) * act_dim]
        if act == ActionType.RPM:
            rpm = [hover * (1.0 + 0.05 * a[k]) for k in range(4)]
        else:  # ONE_D_RPM: one action over the four motors
            rpm = [hover * (1.0 + 0.05 * a[0])] * 4
        rpms.append(rpm)
        # history ring: oldest first (reference BaseRLAviary.py:66-67)
        buf = carry[base + buf_off:base + buf_off + buf_rows]
        new_bufs.append(torch.cat([buf[act_dim:], a]) if buf_rows else buf)
        thrust, xt, yt, zt = kernel_dyn.motor_mix_rows(params, *rpm)
        stepped.append(kernel_dyn.dyn_substeps_rows(
            params, cfg.steps_per_ctrl, cfg.pyb_dt, tuple(st),
            thrust, xt, yt, zt))

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
    for d in range(n):
        base, ob = d * per_drone, d * obs_rows_per
        for k in range(S):
            carry_out[base + k] = torch.where(done, spec.init16[d][k],
                                              stepped[d][k])
        for k in range(LR):
            carry_out[base + S + k] = torch.where(done, 0.0, rpms[d][k])
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
    carry_out[n * per_drone] = torch.where(done, 0.0, sc_new)
    ro = n * obs_rows_per
    outs[ro] = reward
    outs[ro + 1] = term.to(carry.dtype)
    outs[ro + 2] = trunc.to(carry.dtype)
    return carry_out, outs


def fused_env_step(spec: FusedSpec, carry: torch.Tensor,
                   action_rows: torch.Tensor):
    """The kernel's wrapper: one fully-fused control step.

    carry: (RC, B) float32 row block (see the module docstring);
    action_rows: (N*A, B), drone-major.  Returns (carry', outs (RO, B)).
    A CUDA tensor launches the CUDA kernel on the current stream (no
    synchronisation; outputs from `torch.empty`); a CPU tensor runs
    `fused_env_step_plain`.  Anything the kernel does not take raises.
    """
    global launches
    check_rows("carry", carry, spec.carry_rows)
    check_rows("action_rows", action_rows, spec.n * spec.act_dim, like=carry)
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
                 carry_out.data_ptr(), outs.data_ptr(), b, carry.stride(0),
                 ctypes.byref(_step_params(spec)),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_env_step launch failed: CUDA error {err}")
    launches += 1
    return carry_out, outs


def pack_carry(state_leaves: dict, n: int, buf_rows: int, b: int,
               act: ActionType = ActionType.RPM, device=None) -> torch.Tensor:
    """numpy EnvState-like leaves (flattened (B*N, k), env-major) ->
    (RC, B) drone-major row block on `device` (None = the CUDA card; no
    lane padding)."""
    device = resolve_device(device)
    per_drone, rc = _layout(n, buf_rows, act)
    buf_off = S + LR
    blk = np.zeros((rc, b), np.float32)
    flat16 = np.concatenate(
        [state_leaves["pos"], state_leaves["quat"], state_leaves["vel"],
         state_leaves["rpy_rates"], state_leaves["ang_v"]], axis=-1)
    for d in range(n):
        base = d * per_drone
        blk[base:base + S] = flat16[d::n].T            # (16, B)
        blk[base + S:base + S + LR] = state_leaves["last_rpm"][d::n].T
        if buf_rows:
            blk[base + buf_off:base + buf_off + buf_rows] = \
                state_leaves["action_buffer"][d::n].reshape(b, buf_rows).T
    blk[n * per_drone] = np.asarray(state_leaves["step_counter"], np.float32)
    return torch.from_numpy(blk).to(device)


def unpack_outs(outs: torch.Tensor, n: int, buf_rows: int,
                obs_layout: str = "flat"):
    """(RO, B) outputs -> (obs, reward (B,), term (B,) bool, trunc).

    obs_layout "rows" returns the (N*D, B) row block as it is; "flat" and
    "drone" return transposed VIEWS of it, (B, N*D) and (B, N, D): no copy
    is made per step.
    """
    obs_rows_per = 12 + buf_rows
    ro = n * obs_rows_per
    obs = outs[:ro]                                    # (N*D, B)
    if obs_layout != "rows":
        obs = obs.t()                                  # (B, N*D)
        if obs_layout == "drone":
            obs = obs.unflatten(1, (n, obs_rows_per))
    return obs, outs[ro], outs[ro + 1] > 0.5, outs[ro + 2] > 0.5
