"""The plain reference's environment, built from a configuration file.

`make(config)` reads a `configs/<name>.json` and returns a `RefEnv`: the
drone, the task's row hooks (Hover or Routing, as upstream
gym-pybullet-drones' HoverAviary and the routing fork define them), the
carry layout, the reset state, and `step(carry, action_rows)`, which is
`rows.fused_env_step_plain`.  Everything is computed from the file: the
reference takes no constant, table or state from the program.

The carry layout is the documented format of the port's fused step (one
(RC, B) float32 row block, columns are envs; per drone 16 state rows
[pos3 quat4 vel3 rpy_rates3 ang_v3], 4 last-rpm rows, 9 PID rows for
PID-type actions, the action ring, then one step-counter row), so the
reference can read a carry the program hands out and step it itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from portbench.reference import rows
from portbench.reference.rows import G, ActionType, DroneModel, Physics

TASK_HOVER, TASK_ROUTING = 0, 2
ROUTING_TILT = 0.8


@dataclasses.dataclass(frozen=True)
class Drone:
    """A quadrotor's constants (a URDF's) and the derived ones upstream's
    BaseAviary computes from them."""
    model: DroneModel
    m: float
    l: float
    thrust2weight: float
    ixx: float
    iyy: float
    izz: float
    kf: float
    km: float
    collision_h: float
    collision_r: float
    collision_z_offset: float
    max_speed_kmh: float
    gnd_eff_coeff: float
    prop_radius: float
    drag_coeff_xy: float
    drag_coeff_z: float
    dw_coeff_1: float
    dw_coeff_2: float
    dw_coeff_3: float
    prop_offsets: tuple

    @property
    def gravity(self) -> float:
        return G * self.m

    @property
    def hover_rpm(self) -> float:
        return math.sqrt(self.gravity / (4 * self.kf))

    @property
    def max_rpm(self) -> float:
        return math.sqrt((self.thrust2weight * self.gravity) / (4 * self.kf))

    @property
    def gnd_eff_h_clip(self) -> float:
        max_thrust = 4 * self.kf * self.max_rpm ** 2
        return 0.25 * self.prop_radius * math.sqrt(
            (15 * self.max_rpm ** 2 * self.kf * self.gnd_eff_coeff)
            / max_thrust)

    @property
    def speed_limit(self) -> float:
        return 0.03 * self.max_speed_kmh * (1000 / 3600)

    @property
    def drag_coeff(self) -> tuple:
        return (self.drag_coeff_xy, self.drag_coeff_xy, self.drag_coeff_z)


@dataclasses.dataclass(frozen=True)
class Config:
    drone: Drone
    num_drones: int
    physics: Physics
    pyb_freq: int
    ctrl_freq: int
    init_xyzs: tuple
    obstacles: tuple = ()
    solver_iterations: int = 4

    @property
    def steps_per_ctrl(self) -> int:
        return self.pyb_freq // self.ctrl_freq

    @property
    def pyb_dt(self) -> float:
        return 1.0 / self.pyb_freq

    @property
    def ctrl_dt(self) -> float:
        return 1.0 / self.ctrl_freq


class RowConsts(NamedTuple):
    """What a task's `row_post` needs beside the state rows."""
    task_id: int
    targets: tuple
    box_xy: float
    box_z: float
    tilt: float
    episode_len_sec: float
    arrival_tol: float = 0.0
    collision_radius: float = 0.0
    shaped: bool = False
    progress_gain: float = 0.0
    arrival_hold: float = 0.0
    n_extra_obs_rows: int = 0


@dataclasses.dataclass(frozen=True)
class HoverTask:
    """upstream HoverAviary: reward max(0, 2 - |tgt - p|^4), terminated at
    the target, truncated outside the box, tilted past 0.4 rad, or after
    the episode."""
    act: ActionType
    target_pos: tuple
    episode_len_sec: float
    n_extra_obs_rows = 0
    row_extra_obs = None

    def row_consts(self, cfg):
        return RowConsts(TASK_HOVER, (tuple(self.target_pos),), 1.5, 2.0,
                         0.4, self.episode_len_sec)

    def row_post(self, cfg, drones, sc_row):
        c = self.row_consts(cfg)
        d0 = drones[0]
        tx, ty, tz = c.targets[0]
        px, py, pz = d0["p"]
        roll, pitch, _ = d0["rpy"]
        dx, dy, dz = tx - px, ty - py, tz - pz
        d2 = dx * dx + dy * dy + dz * dz
        reward = torch.clamp(2.0 - d2 * d2, min=0.0)
        term = d2 < 1e-8
        out = (torch.abs(px) > c.box_xy) | (torch.abs(py) > c.box_xy) \
            | (pz > c.box_z) | (torch.abs(roll) > c.tilt) \
            | (torch.abs(pitch) > c.tilt)
        timeout = (sc_row / cfg.pyb_freq) > c.episode_len_sec
        return reward, term, out | timeout


@dataclasses.dataclass(frozen=True)
class RoutingTask:
    """The routing fork's fleet: each drone flies relative PID waypoints to
    its own destination; shaped progress reward, an arrival hold bonus and
    a separation penalty; terminated when every drone has arrived,
    truncated when any tilts past 0.8 rad or after the episode."""
    act: ActionType
    destinations: tuple
    episode_len_sec: float
    arrival_tol: float
    collision_radius: float
    step_size: float
    relative_actions: bool
    shaped: bool
    progress_gain: float
    arrival_hold: float
    action_scale: float
    n_extra_obs_rows = 6

    def row_consts(self, cfg):
        dests = tuple(tuple(row) for row in torch.tensor(
            self.destinations, dtype=torch.float32).tolist())
        return RowConsts(
            TASK_ROUTING, dests, float("inf"), float("inf"), ROUTING_TILT,
            self.episode_len_sec, arrival_tol=self.arrival_tol,
            collision_radius=self.collision_radius, shaped=self.shaped,
            progress_gain=self.progress_gain,
            arrival_hold=self.arrival_hold,
            n_extra_obs_rows=self.n_extra_obs_rows)

    def row_extra_obs(self, cfg, drones):
        """Per drone: the goal vector, then the displacement to the nearest
        neighbour (strict < over ascending j)."""
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
            if best is None:
                best = [pi[0] * 0.0] * 3
            extras.append(goal + best)
        return extras

    def row_post(self, cfg, drones, sc_row):
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
            t = (torch.abs(roll) > ROUTING_TILT) \
                | (torch.abs(pitch) > ROUTING_TILT)
            tilted_any = t if tilted_any is None else tilted_any | t
        r2 = self.collision_radius * self.collision_radius
        for i in range(n):
            for j in range(i + 1, n):
                pi, pj = drones[i]["p"], drones[j]["p"]
                dd = [pi[k] - pj[k] for k in range(3)]
                d2 = dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]
                reward = reward - 10.0 * (d2 < r2).to(reward.dtype)
        timeout = (sc_row / cfg.pyb_freq) > self.episode_len_sec
        return reward, term_all, tilted_any | timeout


ACT_DIMS = {ActionType.RPM: 4, ActionType.VEL: 4, ActionType.PID: 3,
            ActionType.ONE_D_RPM: 1, ActionType.ONE_D_PID: 1}


@dataclasses.dataclass(frozen=True)
class RefEnv:
    """What `rows.fused_env_step_plain` reads as its `spec`, plus the reset
    state and the step."""
    cfg: Config
    task: object
    init16: tuple
    pid_drone: Drone

    @property
    def n(self) -> int:
        return self.cfg.num_drones

    @property
    def act_dim(self) -> int:
        return ACT_DIMS[self.task.act]

    @property
    def buf_rows(self) -> int:
        return (self.cfg.ctrl_freq // 2) * self.act_dim

    @property
    def n_extra(self) -> int:
        return self.task.n_extra_obs_rows

    @property
    def obs_rows_per(self) -> int:
        return 12 + self.buf_rows + self.n_extra

    @property
    def out_rows(self) -> int:
        return self.n * self.obs_rows_per + 3

    @property
    def per_drone(self) -> int:
        return rows._layout(self.n, self.buf_rows, self.task.act)[0]

    @property
    def carry_rows(self) -> int:
        return rows._layout(self.n, self.buf_rows, self.task.act)[1]

    def nn_ties(self, carry: torch.Tensor, margin: float = 1e-5):
        """(B,) bool: envs in which some drone's two nearest neighbours lie
        within `margin` (relative) of each other in squared distance, in
        the carry's state; there the nearest-neighbour observation is
        decided by rounding.  None for a task without that observation."""
        if not self.n_extra or self.n < 3:
            return None
        per = self.per_drone
        pos = torch.stack([carry[d * per:d * per + 3] for d in range(self.n)])
        pos = pos.permute(2, 0, 1)                               # (B, N, 3)
        d2 = ((pos[:, :, None] - pos[:, None, :]) ** 2).sum(-1)
        eye = torch.eye(self.n, dtype=torch.bool, device=carry.device)
        two = d2.masked_fill(eye, float("inf")).topk(2, dim=-1,
                                                     largest=False).values
        return ((two[..., 1] - two[..., 0]) <= margin * two[..., 0]).any(-1)

    def timeout_step(self) -> int:
        """The control step, counted from 0 after a reset, whose flags
        truncate an env that nothing else has ended: the first after which
        the physics steps since the reset, over `pyb_freq`, exceed the
        episode's seconds (the same float32 test the step makes)."""
        spc, freq = self.cfg.steps_per_ctrl, self.cfg.pyb_freq
        limit = torch.tensor(self.task.episode_len_sec, dtype=torch.float32)
        k = max(0, int(self.task.episode_len_sec * freq / spc) - 2)
        while not bool(torch.tensor(float((k + 1) * spc), dtype=torch.float32)
                       / freq > limit):
            k += 1
        return k

    def step(self, carry: torch.Tensor, action_rows: torch.Tensor):
        """carry (RC, B), action rows (N*A, B) -> (carry', outs (RO, B)),
        outs = per drone its obs rows, then reward, terminated, truncated
        rows."""
        return rows.fused_env_step_plain(self, carry, action_rows)

    def reset(self, b: int, device, dtype=torch.float32):
        """(carry (RC, B), obs rows (N*D, B)) of B envs at the reset
        state."""
        carry = torch.zeros((self.carry_rows, b), dtype=dtype, device=device)
        for d in range(self.n):
            for k in range(16):
                carry[d * self.per_drone + k] = self.init16[d][k]
        return carry, self.obs_of(carry)

    def obs_of(self, carry: torch.Tensor) -> torch.Tensor:
        """The observation rows (N*D, B) of a carry, as the step writes
        them for its selected state."""
        n, per, buf = self.n, self.per_drone, self.buf_rows
        buf_off = per - buf
        out = torch.empty((n * self.obs_rows_per, carry.shape[1]),
                          dtype=carry.dtype, device=carry.device)
        dinfo = []
        for d in range(n):
            sel, ob = carry[d * per:d * per + 16], d * self.obs_rows_per
            roll, pitch, yaw = rows.quat_rpy_rows(*sel[3:7])
            out[ob:ob + 3] = sel[0:3]
            out[ob + 3], out[ob + 4], out[ob + 5] = roll, pitch, yaw
            out[ob + 6:ob + 9] = sel[7:10]
            out[ob + 9:ob + 12] = sel[13:16]
            out[ob + 12:ob + 12 + buf] = \
                carry[d * per + buf_off:d * per + buf_off + buf]
            dinfo.append({"p": list(sel[0:3])})
        if self.n_extra:
            for d, extra in enumerate(self.task.row_extra_obs(self.cfg,
                                                              dinfo)):
                ob = d * self.obs_rows_per + 12 + buf
                for k, row in enumerate(extra):
                    out[ob + k] = row
        return out


def drone_of(spec: dict) -> Drone:
    fields = dict(spec)
    fields["model"] = DroneModel(fields["model"])
    fields["prop_offsets"] = tuple(tuple(float(x) for x in p)
                                   for p in fields["prop_offsets"])
    return Drone(**fields)


def make(config: dict) -> RefEnv:
    """The reference env of a configuration file's contents."""
    env = config["env"]
    drone = drone_of(config["drone"])
    n = int(env["num_drones"])
    init = env.get("init_xyzs")
    if init is None:
        # upstream BaseAviary's default: on the ground, spread along x
        z = drone.collision_h / 2 - drone.collision_z_offset + 0.1
        init = [(4 * drone.l * i, 4 * drone.l * i, z) for i in range(n)]
    cfg = Config(drone, n, Physics(env["physics"]), int(env["pyb_freq"]),
                 int(env["ctrl_freq"]),
                 tuple(tuple(float(x) for x in p) for p in init),
                 (), int(env.get("solver_iterations", 4)))
    t = dict(env["task"])
    kind = t.pop("kind")
    t["act"] = ActionType(t["act"])
    t.pop("obs", None)
    if kind == "hover":
        task = HoverTask(target_pos=tuple(t.pop("target_pos")), **t)
    elif kind == "routing":
        task = RoutingTask(destinations=tuple(
            tuple(float(x) for x in p) for p in t.pop("destinations")), **t)
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    # float32 reset state, the rows the card holds
    pos = torch.tensor(cfg.init_xyzs, dtype=torch.float32).tolist()
    init16 = tuple(tuple(p) + (0.0, 0.0, 0.0, 1.0) + (0.0,) * 9
                   for p in pos)
    return RefEnv(cfg, task, init16, drone)
