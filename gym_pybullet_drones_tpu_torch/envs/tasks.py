"""Task layer: action preprocessing, observations, rewards, termination.

Counterpart of the JAX package's `envs/tasks.py`:
- CtrlTask      <- CtrlAviary      (reference envs/CtrlAviary.py)
- VelocityTask  <- VelocityAviary  (reference envs/VelocityAviary.py)
- RLTask        <- BaseRLAviary    (reference envs/BaseRLAviary.py)
- HoverTask     <- HoverAviary     (reference envs/HoverAviary.py)
- MultiHoverTask<- MultiHoverAviary(reference envs/MultiHoverAviary.py)

Each task is a frozen (hashable) dataclass; its methods are pure functions
of (cfg, state).  The per-env methods broadcast over leading batch dims
(leaves (..., N, k)); the `flat_*` hooks work on the flattened (B*N, k)
carry of `envs/fast.py`; `row_post` works on (B,) row tensors and is what
the fused kernel computes (`csrc/drone_kernels.cuh` holds its CUDA twin,
selected by `row_consts().task_id`).

The embedded DSL-PID controllers of the reference (one Python object per
drone, BaseRLAviary.py:73-78) are the PIDState carried in EnvState,
advanced inside `_map_to_rpm`.  Reference quirk preserved: embedded
controllers always use CF2X parameters whatever the configured drone model
(reference BaseRLAviary.py:76, VelocityAviary.py:62).

All five action types are ported, and both observation types: KIN, and
RGB, each drone's 48x64x4 ray-traced camera image (one launch of the
render kernel, `ops/kernel_render.py`, on the card; its plain version
`ops/render.py` on the CPU).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.params import CF2X
from gym_pybullet_drones_tpu_torch.utils.graphs import constant
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType)
from gym_pybullet_drones_tpu_torch.ops import kernel_render, render
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops
from gym_pybullet_drones_tpu_torch.ops.kernel_fused import (
    PID_FAMILY, pid_setpoint_consts)
from gym_pybullet_drones_tpu_torch.control import dsl_pid
from gym_pybullet_drones_tpu_torch.envs.core import (
    AviaryConfig, EnvState, next_waypoint, state_vector)

# task ids of the fused kernel (GPD_TASK_* in csrc/drone_kernels.cuh)
TASK_HOVER = 0
TASK_MULTIHOVER = 1
TASK_ROUTING = 2


class RowConsts(NamedTuple):
    """What a task's `row_post` needs beside the state rows; the fused
    kernel receives exactly these numbers in its parameter struct."""

    task_id: int
    targets: tuple          # per scoring drone (tx, ty, tz), Python floats
    box_xy: float           # |x|, |y| limit of the flight box
    box_z: float            # z ceiling
    tilt: float             # |roll|, |pitch| limit [rad]
    episode_len_sec: float
    # routing only (envs/routing.py); `targets` then holds the destinations
    arrival_tol: float = 0.0
    collision_radius: float = 0.0
    shaped: bool = False
    progress_gain: float = 0.0
    arrival_hold: float = 0.0
    n_extra_obs_rows: int = 0


@dataclasses.dataclass(frozen=True)
class CtrlTask:
    """Direct-RPM control env (non-RL).

    Action = raw RPMs clipped to [0, MAX_RPM] (reference CtrlAviary.py:121-140);
    obs = raw 20-dim state per drone (:106-117); dummy reward/term/trunc
    (:144-200).
    """

    def action_buffer_shape(self, cfg: AviaryConfig):
        return (0, 4)

    def action_dim(self, cfg: AviaryConfig) -> int:
        return 4

    def obs_dim(self, cfg: AviaryConfig) -> int:
        return 20

    def preprocess_action(self, cfg, state: EnvState, action):
        return self._map_to_rpm(cfg, state, action)

    def _map_to_rpm(self, cfg, state: EnvState, action):
        """Action -> rpm mapping, independent of batch layout (leaves may be
        (N, k) per-env or (B*N, k) flattened — see envs/fast.py)."""
        return torch.clamp(action, 0.0, cfg.drone.max_rpm), state

    def compute_obs(self, cfg, state: EnvState):
        return state_vector(state)

    def compute_reward(self, cfg, state):
        return torch.full_like(state.pos[..., 0, 0], -1.0)

    def compute_terminated(self, cfg, state):
        return torch.zeros_like(state.pos[..., 0, 0], dtype=torch.bool)

    def compute_truncated(self, cfg, state):
        return torch.zeros_like(state.pos[..., 0, 0], dtype=torch.bool)

    def flat_post(self, cfg, flat: EnvState, num_envs: int, num_drones: int,
                  obs12=None):
        """Post-processing on the FLATTENED (B*N, k) state: (obs (B*N, 20),
        reward (B,), term (B,), trunc (B,)).  `obs12` is the optional
        kernel-emitted kinematic block (unused by this 20-dim obs task)."""
        z = torch.zeros((num_envs,), dtype=flat.pos.dtype,
                        device=flat.pos.device)
        return state_vector(flat), z - 1.0, z.bool(), z.bool()


def _embedded_pid(cfg, state: EnvState, target_pos, target_rpy=None,
                  target_vel=None):
    """Advance the embedded per-drone DSL-PIDs one control tick."""
    rpm, ctrl_state, _, _ = dsl_pid.compute_control(
        CF2X, state.ctrl_state, cfg.ctrl_dt,
        cur_pos=state.pos, cur_quat=state.quat, cur_vel=state.vel,
        target_pos=target_pos, target_rpy=target_rpy, target_vel=target_vel)
    return rpm, state._replace(ctrl_state=ctrl_state)


def _vel_targets(cfg, state: EnvState, action):
    """[vx, vy, vz, speed-fraction] -> (target_rpy, target_vel): hold the
    current yaw, fly along the unit direction (zero for a zero vector)."""
    v = action[..., 0:3]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    v_unit = torch.where(norm > 0, v / torch.where(norm > 0, norm, 1.0), 0.0)
    yaw = quat_ops.quat_to_rpy(state.quat)[..., 2]
    zero = torch.zeros_like(yaw)
    target_rpy = torch.stack([zero, zero, yaw], dim=-1)
    target_vel = cfg.drone.speed_limit * torch.abs(action[..., 3:4]) * v_unit
    return target_rpy, target_vel


@dataclasses.dataclass(frozen=True)
class VelocityTask(CtrlTask):
    """Velocity-command env with embedded DSL-PIDs.

    Action = [vx, vy, vz, speed-fraction] per drone mapped through PID to RPM
    (reference VelocityAviary.py:129-168); speed limit
    0.03 * MAX_SPEED_KMH * 1000/3600 (:78).
    """

    def _map_to_rpm(self, cfg, state: EnvState, action):
        target_rpy, target_vel = _vel_targets(cfg, state, action)
        return _embedded_pid(cfg, state, target_pos=state.pos,
                             target_rpy=target_rpy, target_vel=target_vel)


@dataclasses.dataclass(frozen=True)
class RLTask:
    """Base RL task: 5 action types, KIN observations with action history
    or RGB camera images.

    Parity: reference BaseRLAviary (envs/BaseRLAviary.py) — action buffer of
    ctrl_freq//2 past actions (:66-67), action mappings (:160-239), KIN obs =
    12-dim kinematics + stacked buffer (:243-322), RGB obs = each drone's
    camera (:252-255, :293-306) over the landmark scene (:99-128).
    """

    act: ActionType = ActionType.RPM
    obs: ObservationType = ObservationType.KIN
    # Superset feature (reference resets are always deterministic): uniform
    # reset noise on position [m], attitude [rad], velocity [m/s]
    reset_pos_noise: float = 0.0
    reset_rpy_noise: float = 0.0
    reset_vel_noise: float = 0.0

    def randomize_reset(self, cfg, state: EnvState, draws: torch.Tensor):
        """Move a reset state by the noise: `draws` (..., N, 9) uniforms in
        [-1, 1) (`core.reset_draws`), position in columns 0:3, attitude
        3:6, velocity 6:9; leaves (..., N, k) or flat (B*N, k).  The JAX
        package's arithmetic (its `tasks.py:148-156`): the position plus
        noise, the attitude through its Euler angles plus noise, the
        velocity plus noise.  A task without noise returns `state`."""
        if not (self.reset_pos_noise or self.reset_rpy_noise
                or self.reset_vel_noise):
            return state
        pos = state.pos + self.reset_pos_noise * draws[..., 0:3]
        rpy = quat_ops.quat_to_rpy(state.quat) \
            + self.reset_rpy_noise * draws[..., 3:6]
        vel = state.vel + self.reset_vel_noise * draws[..., 6:9]
        return state._replace(pos=pos, quat=quat_ops.rpy_to_quat(rpy),
                              vel=vel)

    def action_dim(self, cfg) -> int:
        if self.act in (ActionType.RPM, ActionType.VEL):
            return 4
        if self.act == ActionType.PID:
            return 3
        return 1  # ONE_D_RPM, ONE_D_PID

    def action_buffer_shape(self, cfg: AviaryConfig):
        return (cfg.ctrl_freq // 2, self.action_dim(cfg))

    def obs_dim(self, cfg) -> int:
        """Per-drone observation width: the flattened image for RGB."""
        if self.obs == ObservationType.RGB:
            h, w, c = render.IMAGE_SHAPE
            return h * w * c
        buf, adim = self.action_buffer_shape(cfg)
        return 12 + buf * adim

    def preprocess_action(self, cfg, state: EnvState, action):
        # push into the ring (oldest first, like the reference deque);
        # buffer is (..., N, BUF, A), so the shift runs along axis -2
        buf = torch.cat(
            [state.action_buffer[..., 1:, :], action[..., None, :]], dim=-2)
        state = state._replace(action_buffer=buf)
        return self._map_to_rpm(cfg, state, action)

    def _map_to_rpm(self, cfg, state: EnvState, action):
        """Action -> rpm, layout-independent (no buffer push; leaves may be
        per-env (N, k) or flattened (B*N, k) — see envs/fast.py)."""
        hover = cfg.drone.hover_rpm
        if self.act == ActionType.RPM:
            return hover * (1 + 0.05 * action), state
        if self.act == ActionType.ONE_D_RPM:
            rpm = (hover * (1 + 0.05 * action)).repeat_interleave(4, dim=-1)
            return rpm, state
        if self.act in PID_FAMILY:
            tp, trpy, tv, _ = self._pid_targets(cfg, state, action)
            return _embedded_pid(cfg, state, target_pos=tp,
                                 target_rpy=trpy, target_vel=tv)
        raise ValueError(f"unsupported action type {self.act}")

    def _pid_targets(self, cfg, state: EnvState, action):
        """Embedded-PID setpoints (target pos/rpy/vel/rpy_rates), each
        (..., 3), for the PID-family action types.  Layout-independent;
        also what the `pid_dyn_ctrl_step` kernel is fed (envs/fast.py)."""
        zeros = torch.zeros_like(state.pos)
        if self.act == ActionType.PID:
            c = pid_setpoint_consts(self)
            dest = state.pos + c.action_scale * action if c.relative \
                else action
            return (next_waypoint(state.pos, dest, step_size=c.step_size),
                    zeros, zeros, zeros)
        if self.act == ActionType.VEL:
            target_rpy, target_vel = _vel_targets(cfg, state, action)
            return state.pos, target_rpy, target_vel, zeros
        if self.act == ActionType.ONE_D_PID:
            delta = 0.1 * torch.nn.functional.pad(action, (2, 0))
            return state.pos + delta, zeros, zeros, zeros
        raise ValueError(f"unsupported action type {self.act}")

    def compute_obs(self, cfg, state: EnvState):
        """KIN: (..., N, 12 + BUF*A) [pos, rpy, vel, ang_v] + action history
        (reference BaseRLAviary.py:293-322).  RGB: (..., N, 48, 64, 4), the
        camera of each drone, which sees the other drones of its env
        (reference :252-255, :293-306), rendered as `flat_post` renders
        it: one launch of the render kernel on the card."""
        if self.obs == ObservationType.RGB:
            n = state.pos.shape[-2]
            rgba = kernel_render.render_drones(
                cfg.drone, render.landmark_scene(), state.pos.reshape(-1, 3),
                state.quat.reshape(-1, 4), n)
            return rgba.reshape(state.pos.shape[:-1] + render.IMAGE_SHAPE)
        rpy = quat_ops.quat_to_rpy(state.quat)
        obs12 = torch.cat([state.pos, rpy, state.vel, state.ang_v], dim=-1)
        # (..., N, BUF, A) -> (..., N, BUF*A), oldest first (reference
        # :317-318); drone-major storage makes this a free reshape
        hist = state.action_buffer.flatten(-2)
        return torch.cat([obs12, hist], dim=-1)

    def compute_reward(self, cfg, state):
        return torch.zeros_like(state.pos[..., 0, 0])

    def compute_terminated(self, cfg, state):
        return torch.zeros_like(state.pos[..., 0, 0], dtype=torch.bool)

    def compute_truncated(self, cfg, state):
        return torch.zeros_like(state.pos[..., 0, 0], dtype=torch.bool)

    # ---- flattened fast-path hooks (envs/fast.py) ----

    def flat_post(self, cfg, flat: EnvState, num_envs: int, num_drones: int,
                  obs12=None):
        """Post-processing on the FLATTENED (B*N, k) state: (obs (B*N, D),
        reward (B,), term (B,), trunc (B,)).  `obs12` is the optional
        kernel-emitted kinematic block (B*N, 12).  RGB: the flat cameras,
        each seeing its env's drones, in one render launch (HWC rows of
        48*64*4), and the flags from the Euler angles of the state."""
        b, n = num_envs, num_drones
        if self.obs == ObservationType.RGB:
            obs = kernel_render.render_drones(
                cfg.drone, render.landmark_scene(), flat.pos, flat.quat, n)
            reward, term, trunc = self.flat_reward_done(
                cfg, flat, quat_ops.quat_to_rpy(flat.quat), b, n)
            return obs, reward, term, trunc
        if obs12 is None:
            rpy = quat_ops.quat_to_rpy(flat.quat)              # (B*N, 3)
            obs12 = torch.cat([flat.pos, rpy, flat.vel, flat.ang_v], dim=-1)
        else:
            rpy = obs12[:, 3:6]  # kernel-emitted Euler block
        buf, adim = self.action_buffer_shape(cfg)
        hist = flat.action_buffer.reshape(b * n, buf * adim)
        cols = [obs12, hist]
        extra = self.flat_extra_obs(cfg, flat, num_envs, num_drones)
        if extra is not None:
            cols.append(extra)
        obs = torch.cat(cols, dim=-1)                 # (B*N, D)
        reward, term, trunc = self.flat_reward_done(
            cfg, flat, rpy, num_envs, num_drones)
        return obs, reward, term, trunc

    def flat_extra_obs(self, cfg, flat: EnvState, num_envs: int,
                       num_drones: int):
        """Optional task-specific obs columns appended after the history."""
        return None

    def flat_reward_done(self, cfg, flat: EnvState, rpy, num_envs: int,
                         num_drones: int):
        """(reward (B,), terminated (B,), truncated (B,)) on the flat state."""
        z = torch.zeros((num_envs,), dtype=flat.pos.dtype,
                        device=flat.pos.device)
        return z, z.bool(), z.bool()


@dataclasses.dataclass(frozen=True)
class HoverTask(RLTask):
    """Single-agent hover at TARGET_POS (reference envs/HoverAviary.py).

    reward = max(0, 2 - ||tgt - p||^4) (:68-79); terminated when
    ||tgt - p|| < 1e-4 (:83-96); truncated outside the flight box, when
    tilted > 0.4 rad, or after EPISODE_LEN_SEC (:100-117).
    """

    target_pos: tuple = (0.0, 0.0, 1.0)
    episode_len_sec: float = 8.0

    def _dist(self, state):
        tgt = torch.tensor(self.target_pos, dtype=state.pos.dtype,
                           device=state.pos.device)
        return torch.linalg.norm(tgt - state.pos[..., 0, :], dim=-1)

    def compute_reward(self, cfg, state):
        return torch.clamp(2.0 - self._dist(state) ** 4, min=0.0)

    def compute_terminated(self, cfg, state):
        return self._dist(state) < 1e-4

    def compute_truncated(self, cfg, state):
        pos = state.pos[..., 0, :]
        rpy = quat_ops.quat_to_rpy(state.quat[..., 0, :])
        out = (torch.abs(pos[..., 0]) > 1.5) | (torch.abs(pos[..., 1]) > 1.5) \
            | (pos[..., 2] > 2.0) | (torch.abs(rpy[..., 0]) > 0.4) \
            | (torch.abs(rpy[..., 1]) > 0.4)
        timeout = (state.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return out | timeout

    def flat_reward_done(self, cfg, flat, rpy, num_envs, num_drones):
        b, n = num_envs, num_drones
        # drone 0 per env (reference HoverAviary scores the single drone)
        pos = flat.pos.reshape(b, n, 3)[:, 0]                  # (B, 3)
        rpy0 = rpy.reshape(b, n, 3)[:, 0]
        tgt = constant(tuple(self.target_pos), pos.dtype, pos.device)
        d = torch.linalg.norm(tgt - pos, dim=-1)               # (B,)
        reward = torch.clamp(2.0 - d ** 4, min=0.0)
        term = d < 1e-4
        out = (torch.abs(pos[:, 0]) > 1.5) | (torch.abs(pos[:, 1]) > 1.5) \
            | (pos[:, 2] > 2.0) | (torch.abs(rpy0[:, 0]) > 0.4) \
            | (torch.abs(rpy0[:, 1]) > 0.4)
        timeout = (flat.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return reward, term, out | timeout

    # ---- fused-kernel row hook (ops/kernel_fused.py) ----
    def row_consts(self, cfg) -> RowConsts:
        return RowConsts(TASK_HOVER, (tuple(self.target_pos),), 1.5, 2.0,
                         0.4, self.episode_len_sec)

    def row_post(self, cfg, drones, sc_row):
        """Reward/term/trunc on (B,) row tensors (drone 0 scores).  Note
        the squared forms: term is d^2 < 1e-8 here, d < 1e-4 on the flat
        path; they differ only at ties."""
        c = self.row_consts(cfg)
        d0 = drones[0]
        tx, ty, tz = c.targets[0]
        px, py, pz = d0["p"]
        roll, pitch, _ = d0["rpy"]
        dx, dy, dz = tx - px, ty - py, tz - pz
        d2 = dx * dx + dy * dy + dz * dz
        reward = torch.clamp(2.0 - d2 * d2, min=0.0)  # ||d||^4 == (||d||^2)^2
        term = d2 < 1e-8
        out = (torch.abs(px) > c.box_xy) | (torch.abs(py) > c.box_xy) \
            | (pz > c.box_z) | (torch.abs(roll) > c.tilt) \
            | (torch.abs(pitch) > c.tilt)
        timeout = (sc_row / cfg.pyb_freq) > c.episode_len_sec
        return reward, term, out | timeout


@dataclasses.dataclass(frozen=True)
class MultiHoverTask(RLTask):
    """Multi-agent leader-follower hover (reference envs/MultiHoverAviary.py).

    TARGET_POS = INIT_XYZS + [0, 0, 1/(i+1)] (:71); summed reward (:75-88);
    terminated when the summed distance < 1e-4 (:92-108); truncated when any
    drone leaves the +-2 box / tilts > 0.4 / timeout (:112-130).
    """

    episode_len_sec: float = 8.0

    def _targets(self, cfg, like: torch.Tensor):
        tgt = cfg.default_init_xyzs(like.dtype, like.device).clone()
        i = torch.arange(cfg.num_drones, dtype=like.dtype, device=like.device)
        tgt[:, 2] += 1.0 / (i + 1)
        return tgt                                             # (N, 3)

    def compute_reward(self, cfg, state):
        d = torch.linalg.norm(self._targets(cfg, state.pos) - state.pos,
                              dim=-1)
        return torch.sum(torch.clamp(2.0 - d ** 4, min=0.0), dim=-1)

    def compute_terminated(self, cfg, state):
        d = torch.linalg.norm(self._targets(cfg, state.pos) - state.pos,
                              dim=-1)
        return torch.sum(d, dim=-1) < 1e-4

    def compute_truncated(self, cfg, state):
        rpy = quat_ops.quat_to_rpy(state.quat)
        pos = state.pos
        out = (torch.abs(pos[..., 0]) > 2.0) | (torch.abs(pos[..., 1]) > 2.0) \
            | (pos[..., 2] > 2.0) | (torch.abs(rpy[..., 0]) > 0.4) \
            | (torch.abs(rpy[..., 1]) > 0.4)
        timeout = (state.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return torch.any(out, dim=-1) | timeout

    def flat_reward_done(self, cfg, flat, rpy, num_envs, num_drones):
        b, n = num_envs, num_drones
        tgt = self._targets(cfg, flat.pos)                     # (N, 3)
        d = torch.linalg.norm(tgt.repeat(b, 1) - flat.pos, dim=-1)  # (B*N,)
        out = (torch.abs(flat.pos[:, 0]) > 2.0) \
            | (torch.abs(flat.pos[:, 1]) > 2.0) | (flat.pos[:, 2] > 2.0) \
            | (torch.abs(rpy[:, 0]) > 0.4) | (torch.abs(rpy[:, 1]) > 0.4)
        reward = torch.clamp(2.0 - d ** 4, min=0.0).reshape(b, n).sum(dim=1)
        term = d.reshape(b, n).sum(dim=1) < 1e-4
        timeout = (flat.step_counter / cfg.pyb_freq) > self.episode_len_sec
        trunc = out.reshape(b, n).any(dim=1) | timeout
        return reward, term, trunc

    # ---- fused-kernel row hook (ops/kernel_fused.py) ----
    def row_consts(self, cfg) -> RowConsts:
        # the spawn grid in float32, as the kernel and the flat path see it
        init = cfg.default_init_xyzs(torch.float32, "cpu").tolist()
        targets = tuple((x, y, z + 1.0 / (i + 1))
                        for i, (x, y, z) in enumerate(init))
        return RowConsts(TASK_MULTIHOVER, targets, 2.0, 2.0, 0.4,
                         self.episode_len_sec)

    def row_post(self, cfg, drones, sc_row):
        """Summed reward / summed-distance termination / any-drone
        truncation as row math (cross-drone reductions are row adds)."""
        c = self.row_consts(cfg)
        reward = dist_sum = out_any = None
        for (tx, ty, tz), di in zip(c.targets, drones):
            px, py, pz = di["p"]
            roll, pitch, _ = di["rpy"]
            dx, dy, dz = tx - px, ty - py, tz - pz
            d2 = dx * dx + dy * dy + dz * dz
            r = torch.clamp(2.0 - d2 * d2, min=0.0)
            dd = torch.sqrt(d2)
            out = (torch.abs(px) > c.box_xy) | (torch.abs(py) > c.box_xy) \
                | (pz > c.box_z) | (torch.abs(roll) > c.tilt) \
                | (torch.abs(pitch) > c.tilt)
            reward = r if reward is None else reward + r
            dist_sum = dd if dist_sum is None else dist_sum + dd
            out_any = out if out_any is None else out_any | out
        term = dist_sum < 1e-4
        timeout = (sc_row / cfg.pyb_freq) > c.episode_len_sec
        return reward, term, out_any | timeout
