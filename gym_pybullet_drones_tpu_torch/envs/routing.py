"""Multi-agent routing task: waypoint-stepped navigation to per-drone goals.

Counterpart of the JAX package's `envs/routing.py`, the routing fork's own
capability (reference `_calculateNextStep` BaseAviary.py:1105-1147 and the
adjacency neighborhood machinery :658-675): each drone must reach its own
destination; actions command target positions that are clamped to unit
waypoint steps (exactly the reference's intermediate-waypoint rule), an
embedded DSL-PID flies the waypoints, and the observation exposes both own
kinematics and goal-relative/neighbor information.

Three versions of the task arithmetic exist and must pick the same
answers: the tensor code on (..., N, k) / flat (B*N, k) leaves here, the
row hooks (`row_post`, `row_extra_obs`) on (B,) row tensors that the fused
kernel's plain version calls, and the device functions
`gpd_routing_row_post` / `gpd_routing_extra_obs` in
`csrc/drone_kernels.cuh`.  The nearest neighbour is chosen on the SQUARED
distance in all three, the lowest index winning a tie (drones spawn on a
line at equal spacing, so ties are the normal case at reset).
"""
from __future__ import annotations

import dataclasses

import torch

from gym_pybullet_drones_tpu_torch.params import CF2X
from gym_pybullet_drones_tpu_torch.utils.graphs import constant
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)
from gym_pybullet_drones_tpu_torch.ops import quat as quat_ops
from gym_pybullet_drones_tpu_torch.envs.core import AviaryConfig, EnvState
from gym_pybullet_drones_tpu_torch.envs.tasks import (
    TASK_ROUTING, RLTask, RowConsts)

TILT = 0.8  # |roll|, |pitch| beyond which an episode is truncated [rad]


def _nearest_vec(pos: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) positions -> (..., N, 3) displacement pos_j - pos_i to
    each drone's nearest neighbour j (zeros for a lone drone)."""
    n = pos.shape[-2]
    diff = pos[..., None, :, :] - pos[..., :, None, :]         # [i, j]
    d2 = (diff * diff).sum(dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    d2 = d2.masked_fill(eye, float("inf"))
    nearest = torch.argmin(d2, dim=-1)     # the first minimum: lowest index
    idx = nearest[..., None, None].expand(nearest.shape + (1, 3))
    return torch.gather(diff, -2, idx)[..., 0, :]


@dataclasses.dataclass(frozen=True)
class RoutingTask(RLTask):
    """Per-drone goal navigation with waypoint stepping and safety shaping.

    destinations: ((x, y, z), ...) per drone (tuple -> hashable/static).
    Action (PID type): a step_size-scaled displacement per drone (see
    relative_actions below), waypoint-clamped per control step exactly as
    the reference's intermediate-waypoint rule clamps absolute
    destinations.
    Reward (shaped=True, the trainable default): per-drone PROGRESS rate
    toward the goal (velocity projected on the goal direction, gated off
    within arrival_tol) + a per-step arrival hold bonus - separation
    penalty.  shaped=False keeps the plain -distance form for analysis.
    """

    act: ActionType = ActionType.PID
    obs: ObservationType = ObservationType.KIN
    destinations: tuple = ((1.0, 1.0, 1.0),)
    episode_len_sec: float = 16.0
    arrival_tol: float = 0.05
    collision_radius: float = 0.12
    step_size: float = 1.0
    # trainable action parameterization: the policy emits a
    # step_size-scaled displacement from the current position (the
    # waypoint the drone should fly next), not an absolute world
    # destination (the reference BaseRLAviary PID convention,
    # relative_actions=False)
    relative_actions: bool = True
    shaped: bool = True
    progress_gain: float = 10.0
    arrival_hold: float = 2.0
    # displacement scale for relative actions (smaller than the waypoint
    # clamp: a unit policy output commands a 0.25 m step)
    action_scale: float = 0.25

    def _dest(self, like: torch.Tensor) -> torch.Tensor:
        return constant(self.destinations, like.dtype, like.device)

    def obs_dim(self, cfg) -> int:
        # kinematics + action history + goal vector + nearest-neighbor vector
        return super().obs_dim(cfg) + 6

    def compute_obs(self, cfg, state: EnvState):
        base = super().compute_obs(cfg, state)           # (..., N, 12 + hist)
        goal_vec = self._dest(state.pos) - state.pos     # (..., N, 3)
        return torch.cat([base, goal_vec, _nearest_vec(state.pos)], dim=-1)

    def _reward_terms(self, cfg, gv, vel):
        """Per-drone reward share and arrival flag from the goal vector
        (..., 3) and the velocity (..., 3)."""
        d = torch.linalg.norm(gv, dim=-1)
        arrived = d < self.arrival_tol
        af = arrived.to(gv.dtype)
        if not self.shaped:
            return -d + 10.0 * af, arrived
        unit = gv / torch.clamp(d, min=self.arrival_tol)[..., None]
        prog = torch.sum(vel * unit, dim=-1) * cfg.ctrl_dt
        # smooth hold bonus: exp(-d/tol) is dense through the final approach
        hold = torch.exp(-d / self.arrival_tol)
        return (self.progress_gain * prog * (1.0 - af)
                + self.arrival_hold * hold), arrived

    def _penalty(self, pos):
        """(..., N, 3) -> (...,) count of ordered pairs closer than the
        collision radius (each unordered pair counts twice)."""
        n = pos.shape[-2]
        diff = pos[..., None, :, :] - pos[..., :, None, :]
        dist = torch.linalg.norm(diff, dim=-1)
        close = (dist < self.collision_radius) & ~torch.eye(
            n, dtype=torch.bool, device=pos.device)
        return close.to(pos.dtype).sum(dim=(-2, -1))

    def compute_reward(self, cfg, state):
        per, _ = self._reward_terms(cfg, self._dest(state.pos) - state.pos,
                                    state.vel)
        return per.sum(dim=-1) - 5.0 * self._penalty(state.pos)

    def compute_terminated(self, cfg, state):
        d = torch.linalg.norm(self._dest(state.pos) - state.pos, dim=-1)
        return torch.all(d < self.arrival_tol, dim=-1)

    def compute_truncated(self, cfg, state):
        rpy = quat_ops.quat_to_rpy(state.quat)
        tilted = torch.any((torch.abs(rpy[..., 0]) > TILT)
                           | (torch.abs(rpy[..., 1]) > TILT), dim=-1)
        timeout = (state.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return tilted | timeout

    # ---- flattened fast-path hooks (envs/fast.py) ----

    def flat_extra_obs(self, cfg, flat, num_envs, num_drones):
        b, n = num_envs, num_drones
        goal_vec = self._dest(flat.pos).repeat(b, 1) - flat.pos  # (B*N, 3)
        nn_vec = _nearest_vec(flat.pos.reshape(b, n, 3))
        return torch.cat([goal_vec, nn_vec.reshape(b * n, 3)], dim=-1)

    def flat_reward_done(self, cfg, flat, rpy, num_envs, num_drones):
        b, n = num_envs, num_drones
        gv = self._dest(flat.pos).repeat(b, 1) - flat.pos        # (B*N, 3)
        per, arrived = self._reward_terms(cfg, gv, flat.vel)
        reward = per.reshape(b, n).sum(dim=-1) \
            - 5.0 * self._penalty(flat.pos.reshape(b, n, 3))
        term = arrived.reshape(b, n).all(dim=-1)
        rpy2 = rpy.reshape(b, n, 3)
        tilted = torch.any((torch.abs(rpy2[..., 0]) > TILT)
                           | (torch.abs(rpy2[..., 1]) > TILT), dim=-1)
        timeout = (flat.step_counter / cfg.pyb_freq) > self.episode_len_sec
        return reward, term, tilted | timeout

    # ---- fused-kernel row hooks (ops/kernel_fused.py) ----
    # Cross-drone reductions (nearest neighbor, pair separation) are plain
    # row arithmetic when rows are drone-major and columns are envs.

    @property
    def n_extra_obs_rows(self) -> int:
        return 6  # goal vector + nearest-neighbor displacement

    def row_consts(self, cfg) -> RowConsts:
        # destinations in float32, as the kernel sees them
        dests = tuple(tuple(row) for row in torch.tensor(
            self.destinations, dtype=torch.float32).tolist())
        return RowConsts(
            TASK_ROUTING, dests, float("inf"), float("inf"), TILT,
            self.episode_len_sec, arrival_tol=self.arrival_tol,
            collision_radius=self.collision_radius, shaped=self.shaped,
            progress_gain=self.progress_gain,
            arrival_hold=self.arrival_hold,
            n_extra_obs_rows=self.n_extra_obs_rows)

    def row_extra_obs(self, cfg, drones):
        """Per drone, 6 rows: goal vector, then the displacement to the
        nearest neighbour (strict < over ascending j: the lowest index wins
        a tie, as `argmin` does in `_nearest_vec`)."""
        n = len(drones)
        extras = []
        for i in range(n):
            pi = drones[i]["p"]
            dest = self.destinations[i]
            goal = [float(dest[k]) - pi[k] for k in range(3)]
            best_d2, best = None, None
            for j in range(n):
                if j == i:
                    continue
                pj = drones[j]["p"]
                diff = [pj[k] - pi[k] for k in range(3)]
                d2 = (diff[0] * diff[0] + diff[1] * diff[1]
                      + diff[2] * diff[2])
                if best is None:
                    best_d2, best = d2, diff
                else:
                    take = d2 < best_d2
                    best = [torch.where(take, diff[k], best[k])
                            for k in range(3)]
                    best_d2 = torch.where(take, d2, best_d2)
            if best is None:                       # single drone: zero rows
                best = [pi[0] * 0.0] * 3
            extras.append(goal + best)
        return extras

    def row_post(self, cfg, drones, sc_row):
        """Reward / all-arrived termination / any-tilted-or-timeout
        truncation on (B,) row tensors."""
        n = len(drones)
        reward = term_all = tilted_any = None
        ctrl_dt = cfg.ctrl_dt
        for i in range(n):
            pi, vi = drones[i]["p"], drones[i]["v"]
            roll, pitch, _ = drones[i]["rpy"]
            dest = self.destinations[i]
            dx = [float(dest[k]) - pi[k] for k in range(3)]
            d = torch.sqrt(dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2])
            arrived = d < self.arrival_tol
            af = arrived.to(d.dtype)
            if self.shaped:
                inv = 1.0 / torch.clamp(d, min=self.arrival_tol)
                prog = ((vi[0] * dx[0] + vi[1] * dx[1] + vi[2] * dx[2])
                        * inv * ctrl_dt)
                hold = torch.exp(-d / self.arrival_tol)
                r = (self.progress_gain * prog * (1.0 - af)
                     + self.arrival_hold * hold)
            else:
                r = -d + 10.0 * af
            reward = r if reward is None else reward + r
            term_all = arrived if term_all is None else term_all & arrived
            t = (torch.abs(roll) > TILT) | (torch.abs(pitch) > TILT)
            tilted_any = t if tilted_any is None else tilted_any | t
        # separation penalty: each unordered pair counts twice, matching
        # flat_reward_done's sum over the full (i, j) matrix
        r2 = self.collision_radius * self.collision_radius
        for i in range(n):
            for j in range(i + 1, n):
                pi, pj = drones[i]["p"], drones[j]["p"]
                dd = [pi[k] - pj[k] for k in range(3)]
                d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
                reward = reward - 10.0 * (d2 < r2).to(reward.dtype)
        timeout = (sc_row / cfg.pyb_freq) > self.episode_len_sec
        return reward, term_all, tilted_any | timeout


def make_routing_config(num_drones: int = 4, spacing: float = 0.5,
                        physics=None, pyb_freq: int = 240,
                        ctrl_freq: int = 30):
    """Convenience: a line of drones routed to reversed goal positions.

    The default physics is PYB, as in the JAX package: the drones collide
    with the ground and with each other.
    """
    inits = tuple((i * spacing, 0.0, 0.3) for i in range(num_drones))
    dests = tuple(((num_drones - 1 - i) * spacing, 1.5, 1.0)
                  for i in range(num_drones))
    cfg = AviaryConfig(drone=CF2X, num_drones=num_drones,
                       physics=physics or Physics.PYB, pyb_freq=pyb_freq,
                       ctrl_freq=ctrl_freq, init_xyzs=inits,
                       neighbourhood_radius=1.0)
    task = RoutingTask(destinations=dests)
    return cfg, task
