"""Functional environment core: config, state, reset/step.

Counterpart of the JAX package's `envs/core.py`.  An environment is a pure
function over a NamedTuple of tensors:

    step(cfg, task, state, action) -> (state, obs, reward, term, trunc, info)

The subclass hooks of the reference's template-method engine
(BaseAviary.py:1018-1101) are methods of a frozen Task dataclass
(`envs/tasks.py`).  Where the JAX package maps these functions over envs
with `vmap`, here every function broadcasts over leading batch dimensions
written out: leaves are (..., N, k) with N = num_drones.

Stepping semantics parity (reference BaseAviary.py:339-383):
- preprocess action once per control step,
- PYB_STEPS_PER_CTRL = pyb_freq // ctrl_freq physics substeps,
- obs/reward/terminated/truncated computed once per control step,
- `last_rpm` updated at the END of each substep, so the drag model's first
  substep uses the previous control step's rpm (reference :359,372),
- step_counter advances by PYB_STEPS_PER_CTRL, AFTER the hooks ran.

Every physics mode runs here: the explicit DYN integrator
(`ops/dynamics.py`) and the PYB family, the Bullet-like integrator with
ground, obstacle and drone-drone contact (`ops/rigid_body.py`) under the
aero effects its mode names (`ops/aero.py`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.params import DroneParams
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.graphs import constant
from gym_pybullet_drones_tpu_torch.utils.enums import Physics
from gym_pybullet_drones_tpu_torch.ops import aero, quat as quat_ops
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState, dyn_step
from gym_pybullet_drones_tpu_torch.ops.rigid_body import (
    PybState, pyb_step, resolve_drone_collisions)
from gym_pybullet_drones_tpu_torch.control import dsl_pid


class EnvState(NamedTuple):
    """Full simulation state (N = num_drones; leading batch dims allowed).

    `ctrl_state` is a nested tuple: code that walks the leaves goes through
    `map_leaves`.  Where the JAX package's EnvState carries a PRNG key for
    randomized resets, the port carries none: the reset noise comes from a
    CPU `torch.Generator` that the caller owns (`reset`, `step_autoreset`,
    `envs/fast.py`'s `ResetNoise`).
    """

    pos: torch.Tensor            # (..., N, 3)
    quat: torch.Tensor           # (..., N, 4) xyzw
    vel: torch.Tensor            # (..., N, 3)
    rpy_rates: torch.Tensor      # (..., N, 3)  body rates carry (DYN mode)
    ang_v: torch.Tensor          # (..., N, 3)  world angular velocity
    last_rpm: torch.Tensor       # (..., N, 4)  last applied rpm
    action_buffer: torch.Tensor  # (..., N, BUF, A) action history, oldest
                                 # first, drone-major (the reference's deque
                                 # is time-major, BaseRLAviary.py:66-67)
    ctrl_state: dsl_pid.PIDState  # embedded-PID carry, leaves (..., N, 3)
                                 # (zeros when unused)
    step_counter: torch.Tensor   # (...,) int32, counts PYB substeps


def map_leaves(fn, *trees):
    """Apply `fn` leaf by leaf over NamedTuples of tensors of one structure
    (EnvState with its nested PIDState) and rebuild the structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(*(map_leaves(fn, *xs) for xs in zip(*trees)))


def leaves(tree) -> list:
    """The tensors of a `map_leaves` tree (or one tensor), in order."""
    out = []
    map_leaves(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class AviaryConfig:
    """Static environment configuration (hashable).

    Mirrors the reference constructor surface (BaseAviary.py:25-40) minus the
    GUI/recording options.
    """

    drone: DroneParams
    num_drones: int = 1
    physics: Physics = Physics.PYB
    pyb_freq: int = 240
    ctrl_freq: int = 240
    neighbourhood_radius: float = float("inf")
    # initial poses as nested tuples (hashable); None -> reference default grid
    init_xyzs: tuple | None = None
    init_rpys: tuple | None = None
    # static obstacles: (x, y, z, radius) = sphere, (x, y, z, hx, hy, hz) =
    # axis-aligned box (center + half extents).  Collision in the PYB-family
    # modes (the reference's obstacle bodies, BaseAviary:955-978, approximated
    # by their bounding primitives)
    obstacles: tuple = ()
    # PGS contact-solver sweep count (PYB-family modes).  4 (default) is
    # converged for single-island contacts; PyBullet's numSolverIterations
    # default is 50.  Every entry point takes any value: the kernels loop
    # over the sweeps at run time.
    solver_iterations: int = 4

    def __post_init__(self):
        if self.pyb_freq % self.ctrl_freq != 0:
            raise ValueError("pyb_freq must be divisible by ctrl_freq")

    @property
    def steps_per_ctrl(self) -> int:
        return self.pyb_freq // self.ctrl_freq

    @property
    def pyb_dt(self) -> float:
        return 1.0 / self.pyb_freq

    @property
    def ctrl_dt(self) -> float:
        return 1.0 / self.ctrl_freq

    def default_init_xyzs(self, dtype=torch.float32,
                          device=None) -> torch.Tensor:
        """Reference default spawn grid (BaseAviary.py:194-197), computed
        natively in `dtype` so float64 callers see the exact doubles.
        `device=None` is the CUDA card, as everywhere in the package."""
        device = resolve_device(device)
        if self.init_xyzs is not None:
            return constant(self.init_xyzs, dtype, device).clone()
        d = self.drone
        i = torch.arange(self.num_drones, dtype=dtype, device=device)
        return torch.stack(
            [i * 4 * d.l, i * 4 * d.l, torch.full_like(i, d.init_z)], dim=-1)

    def default_init_rpys(self, dtype=torch.float32,
                          device=None) -> torch.Tensor:
        device = resolve_device(device)
        if self.init_rpys is not None:
            return torch.tensor(self.init_rpys, dtype=dtype, device=device)
        return torch.zeros((self.num_drones, 3), dtype=dtype, device=device)


def state_vector(state: EnvState) -> torch.Tensor:
    """(..., N, 20) per-drone state [pos, quat, rpy, vel, ang_v, last_rpm].

    Layout parity: reference BaseAviary._getDroneStateVector (:541-561).
    """
    rpy = quat_ops.quat_to_rpy(state.quat)
    return torch.cat(
        [state.pos, state.quat, rpy, state.vel, state.ang_v, state.last_rpm],
        dim=-1)


def adjacency_matrix(cfg: AviaryConfig, state: EnvState) -> torch.Tensor:
    """(..., N, N) 0/1 adjacency by neighbourhood radius.

    Parity: reference BaseAviary._getAdjacencyMatrix (:658-675), vectorized.
    """
    diff = state.pos[..., :, None, :] - state.pos[..., None, :, :]
    dist = torch.linalg.norm(diff, dim=-1)
    eye = torch.eye(cfg.num_drones, dtype=torch.bool, device=dist.device)
    return ((dist < cfg.neighbourhood_radius) | eye).to(state.pos.dtype)


def normalized_action_to_rpm(cfg: AviaryConfig,
                             action: torch.Tensor) -> torch.Tensor:
    """De-normalize [-1, 1] actions to [0, MAX_RPM] rpm.

    Parity: reference BaseAviary._normalizedActionToRPM (:893-911) — the
    piecewise-linear map -1 -> 0, 0 -> HOVER_RPM, 1 -> MAX_RPM.  (The
    reference prints a warning on out-of-range input; here inputs are
    clipped.)
    """
    action = torch.clamp(action, -1.0, 1.0)
    d = cfg.drone
    return torch.where(action <= 0, (action + 1) * d.hover_rpm,
                       d.hover_rpm + (d.max_rpm - d.hover_rpm) * action)


def next_waypoint(current_position: torch.Tensor, destination: torch.Tensor,
                  step_size: float = 1.0) -> torch.Tensor:
    """Routing-fork waypoint stepper: move step_size toward destination.

    Parity: reference BaseAviary._calculateNextStep (:1105-1147) — returns the
    destination itself once within step_size, else a unit step toward it.
    Batched over leading dims (the reference is scalar per call).
    """
    direction = destination - current_position
    distance = torch.linalg.norm(direction, dim=-1, keepdim=True)
    safe = torch.where(distance > 0, distance, 1.0)
    stepped = current_position + direction / safe * step_size
    return torch.where(distance <= step_size, destination, stepped)


def _apply_physics_substep(cfg: AviaryConfig, state: EnvState,
                           rpm: torch.Tensor) -> EnvState:
    """One physics substep in the configured mode (reference :349-372),
    general dtype."""
    d = cfg.drone
    dt = cfg.pyb_dt
    mode = cfg.physics
    if mode == Physics.DYN:
        dyn = DynState(pos=state.pos, quat=state.quat, vel=state.vel,
                       rpy_rates=state.rpy_rates, ang_v=state.ang_v)
        out = dyn_step(d, dyn, rpm, dt)
        return state._replace(pos=out.pos, quat=out.quat, vel=out.vel,
                              rpy_rates=out.rpy_rates, ang_v=out.ang_v,
                              last_rpm=rpm)

    # PYB family: compose aero effects as external force/torque about CoM.
    rot = quat_ops.quat_to_mat(state.quat)
    ext_f = torch.zeros_like(state.pos)
    ext_t = torch.zeros_like(state.pos)
    if mode in (Physics.PYB_GND, Physics.PYB_GND_DRAG_DW):
        rpy = quat_ops.quat_to_rpy(state.quat)
        f, t = aero.ground_effect(d, rpm, state.pos, rot, rpy)
        ext_f, ext_t = ext_f + f, ext_t + t
    if mode in (Physics.PYB_DRAG, Physics.PYB_GND_DRAG_DW):
        # stale-action semantics: previous substep's rpm (reference :359)
        f, t = aero.drag(d, state.last_rpm, state.vel, rot)
        ext_f, ext_t = ext_f + f, ext_t + t
    if mode in (Physics.PYB_DW, Physics.PYB_GND_DRAG_DW):
        f, t = aero.downwash(d, state.pos, rot)
        ext_f, ext_t = ext_f + f, ext_t + t

    pyb = PybState(pos=state.pos, quat=state.quat, vel=state.vel,
                   ang_v=state.ang_v)
    out = pyb_step(d, pyb, rpm, dt, ext_force=ext_f, ext_torque=ext_t,
                   obstacles=cfg.obstacles,
                   solver_iterations=cfg.solver_iterations)
    pos, vel, ang_v = out.pos, out.vel, out.ang_v
    if cfg.num_drones > 1:
        # Bullet resolves drone-drone contact in all PYB* modes (every
        # drone lives in one world, reference BaseAviary.py:484-491)
        pos, vel, ang_v = resolve_drone_collisions(
            d, pos, vel, dt, quat=out.quat, ang_v=ang_v)
    return state._replace(pos=pos, quat=out.quat, vel=vel,
                          ang_v=ang_v, last_rpm=rpm)


RESET_NOISE_FIELDS = ("reset_pos_noise", "reset_rpy_noise",
                      "reset_vel_noise")


def has_reset_noise(task) -> bool:
    """Whether `task` randomizes its resets (RLTask's noise fields)."""
    return any(getattr(task, f, 0.0) for f in RESET_NOISE_FIELDS)


def reset_draws(generator: torch.Generator, shape: tuple,
                device=None) -> torch.Tensor:
    """`shape` + (9,) float32 uniforms in [-1, 1) for `randomize_reset`
    (position in columns 0:3, attitude 3:6, velocity 6:9), drawn from the
    explicit CPU `generator` and copied to `device` in one copy.  The same
    generator state gives the same numbers on every device."""
    u = torch.rand(tuple(shape) + (9,), generator=generator) * 2.0 - 1.0
    return host_to_device(u, device)


def host_to_device(u: torch.Tensor, device=None) -> torch.Tensor:
    """Host tensor `u` on `device` in one copy (pinned and asynchronous
    to a card)."""
    device = resolve_device(device)
    if device.type == "cuda":
        return u.pin_memory().to(device, non_blocking=True)
    return u.to(device)


def initial_state(cfg: AviaryConfig, task, dtype=torch.float32, device=None,
                  batch_shape: tuple = ()) -> EnvState:
    """The deterministic reset state (reference BaseAviary.py:194-243),
    leaves `batch_shape` + (N, k)."""
    device = resolve_device(device)
    n = cfg.num_drones
    batch_shape = tuple(batch_shape)
    buf_size, act_dim = task.action_buffer_shape(cfg)
    zeros = lambda *shape: torch.zeros(batch_shape + shape, dtype=dtype,
                                       device=device)
    tile = lambda x: x.expand(batch_shape + x.shape).contiguous()
    return EnvState(
        pos=tile(cfg.default_init_xyzs(dtype, device)),
        quat=tile(quat_ops.rpy_to_quat(cfg.default_init_rpys(dtype,
                                                             device))),
        vel=zeros(n, 3),
        rpy_rates=zeros(n, 3),
        ang_v=zeros(n, 3),
        last_rpm=zeros(n, 4),
        action_buffer=zeros(n, buf_size, act_dim),
        ctrl_state=dsl_pid.init_state(batch_shape + (n,), dtype, device),
        step_counter=torch.zeros(batch_shape, dtype=torch.int32,
                                 device=device),
    )


def reset(cfg: AviaryConfig, task, dtype=torch.float32, device=None,
          generator: torch.Generator | None = None, batch_shape: tuple = ()):
    """Initial (state, obs, info), leaves `batch_shape` + (N, k) (one env
    by default).

    Deterministic like the reference (its reset() ignores the seed,
    BaseAviary.py:243) unless the task has reset noise (RLTask's noise
    fields, a superset feature): then `task.randomize_reset` moves each
    drone by uniforms drawn from the CPU `generator` (`reset_draws`);
    `generator=None` means one seeded with 0, as the JAX package's
    `PRNGKey(0)` (its `core.py:248-249`).  Torch and JAX draw different
    numbers from a seed.
    """
    device = resolve_device(device)
    state = initial_state(cfg, task, dtype, device, batch_shape)
    if has_reset_noise(task):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = reset_draws(generator, state.pos.shape[:-1], device)
        state = task.randomize_reset(cfg, state, draws.to(dtype))
    return state, task.compute_obs(cfg, state), {}


def step(cfg: AviaryConfig, task, state: EnvState, action: torch.Tensor,
         rpm_override: torch.Tensor | None = None):
    """One control step: (state, obs, reward, terminated, truncated, info).

    Control-flow parity with reference BaseAviary.step (:259-383).

    `rpm_override` (..., N, 4), when given, is applied as the rpm of every
    substep as it is: the task's action preprocessing is bypassed, so the
    action buffer is not pushed and the embedded PID does not tick (the
    reference's GUI-slider path, `USE_GUI_RPM`, BaseAviary.py:324-341,
    skips `_preprocessAction`).  `action` is then ignored.
    """
    if rpm_override is not None:
        rpm = torch.as_tensor(rpm_override, dtype=state.pos.dtype,
                              device=state.pos.device)
    else:
        action = torch.as_tensor(action, dtype=state.pos.dtype,
                                 device=state.pos.device)
        rpm, state = task.preprocess_action(cfg, state, action)
    for _ in range(cfg.steps_per_ctrl):
        state = _apply_physics_substep(cfg, state, rpm)
    # Hooks see the PRE-increment step counter: the reference advances
    # step_counter only after obs/reward/terminated/truncated
    # (BaseAviary.py:376-382), so a task's time-based truncation counts the
    # substeps of *previous* control steps only.
    obs = task.compute_obs(cfg, state)
    reward = task.compute_reward(cfg, state)
    terminated = task.compute_terminated(cfg, state)
    truncated = task.compute_truncated(cfg, state)
    state = state._replace(
        step_counter=state.step_counter + cfg.steps_per_ctrl)
    return state, obs, reward, terminated, truncated, {}


def step_autoreset(cfg: AviaryConfig, task, state: EnvState,
                   action: torch.Tensor,
                   generator: torch.Generator | None = None):
    """step() + masked auto-reset on done, for batched RL rollouts.

    Done envs return the terminal reward/flags but the carried state is
    re-initialized, and the post-reset obs is returned (Gymnasium VecEnv
    convention).  Leading batch dims of `state` select per env.

    A task with reset noise re-randomizes: every call draws a reset for
    every env from the CPU `generator` and keeps it where an env is done,
    so `done` is never read back (the JAX package advances every env's key
    either way, its `core.py:332-333`).  Such a task needs the generator:
    None raises.
    """
    noisy = has_reset_noise(task)
    if noisy and generator is None:
        raise ValueError("a task with reset noise re-randomizes its auto-"
                         "resets from a generator: pass `generator`")
    next_state, obs, reward, term, trunc, info = step(cfg, task, state, action)
    done = torch.logical_or(term, trunc)               # (...,)
    init_state, init_obs, _ = reset(cfg, task, dtype=state.pos.dtype,
                                    device=state.pos.device,
                                    generator=generator,
                                    batch_shape=done.shape if noisy else ())

    def pick(i, nxt):
        d = done.reshape(done.shape + (1,) * (nxt.dim() - done.dim()))
        return torch.where(d, i, nxt)
    new_state = map_leaves(pick, init_state, next_state)
    return new_state, pick(init_obs, obs), reward, term, trunc, info
