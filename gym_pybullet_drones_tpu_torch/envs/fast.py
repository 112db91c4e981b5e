"""Fast batched stepping path: kernel physics under the task layer.

Counterpart of the JAX package's `envs/fast.py`, the throughput
configuration used by benchmarks and large-scale training.  Two entry points:

- `make_batched_step`: an inspectable `EnvState` carry with the (env,
  drone) axes collapsed, leaves (B*N, k).  The physics of a whole control
  step is ONE kernel launch over the flattened batch: for DYN
  `ops/kernel_dyn.py` (for the PID-family actions the embedded DSL-PID
  tick and the physics together, `ops/kernel_pid.py`), for the PYB family
  `ops/kernel_env.py`, one thread per (env, drone), with or without the
  PID tick;
  the task logic
  (action mapping or PID setpoints, obs, reward, termination, auto-reset)
  is tensor code on the same flat leaves via the tasks' `_map_to_rpm` /
  `_pid_targets` / `flat_post` hooks.  Deterministic tasks auto-reset to a
  CONSTANT state, tiled once to the batch; a task with reset noise
  re-randomizes each done env from that control step's draws
  (`ResetNoise`).
- `make_fused_rollout`: the carry is one opaque (RC, B) row block and the
  whole control step is ONE kernel launch (`ops/kernel_fused.py`).

Where the JAX package scans on the device, a rollout here is a Python loop
with one launch per control step (on the card the PyTorch operations of
`make_batched_step`'s step replay as CUDA graphs between its kernels);
each takes the `device` the state lives on (None = the CUDA card; "cpu"
runs the kernels' plain PyTorch versions).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.envs import core
from gym_pybullet_drones_tpu_torch.ops import (
    kernel_dyn, kernel_env, kernel_fused, kernel_pid)
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState
from gym_pybullet_drones_tpu_torch.ops.kernel_fused import PID_FAMILY
from gym_pybullet_drones_tpu_torch.params import CF2X
from gym_pybullet_drones_tpu_torch.utils import graphs
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ObservationType, Physics)
from gym_pybullet_drones_tpu_torch.utils.profiling import span


class ResetNoise:
    """The reset noise of a batch of `shape` (..., N) drones, a pure
    function of (seed, draw index): draw 0 is the reset's, draw t + 1 the
    auto-reset draw of control step t.  Uniforms in [-1, 1)
    (`core.reset_draws`) come from one CPU `torch.Generator` seeded with
    `seed`, BLOCK draws at a time, each block copied to `device` in one
    copy; so one seed gives the same draws on the CPU and on the card.  A
    given env's draws depend on the batch's layout, where the JAX
    package's per-env keys do not.  So the stream draws the GLOBAL
    batch's block and keeps `rows`, its (lo, hi) of the leading axis (by
    default all of it): a rank of a mesh keeps its envs' rows, and they
    get the draws they get in one process."""

    BLOCK = 64

    def __init__(self, seed: int, shape: tuple, device, rows=None):
        self.generator = torch.Generator().manual_seed(int(seed))
        self.shape, self.device = tuple(shape), device
        self.rows = (0, self.shape[0]) if rows is None else tuple(rows)
        self.block, self.index = None, 0

    def next(self) -> torch.Tensor:
        """The next draw, `rows` of `shape` + (9,) on the device."""
        k = self.index % self.BLOCK
        if k == 0:
            lo, hi = self.rows
            block = core.reset_draws(
                self.generator, (self.BLOCK,) + self.shape, "cpu")
            self.block = core.host_to_device(
                block[:, lo:hi].contiguous(), self.device)
        self.index += 1
        return self.block[k]

    def get_state(self) -> dict:
        """The stream's position: the draw index, the generator's state and
        the current block (tensors, ints and None only, for a checkpoint)."""
        return {"shape": list(self.shape), "index": self.index,
                "generator": self.generator.get_state(),
                "block": None if self.block is None else self.block.clone()}

    def set_state(self, state: dict) -> None:
        """Continue from `get_state()`'s position: the same draws follow.
        The block is this stream's rows of it."""
        if tuple(state["shape"]) != self.shape:
            raise ValueError(f"a reset-noise stream of shape "
                             f"{tuple(state['shape'])} does not fit "
                             f"{self.shape}")
        block = state["block"]
        rows = self.rows[1] - self.rows[0]
        if block is not None and block.shape[1] != rows:
            raise ValueError(f"a reset-noise block of {block.shape[1]} rows "
                             f"does not fit a stream of {rows}")
        self.index = int(state["index"])
        self.generator.set_state(state["generator"].cpu())
        self.block = None if block is None else block.to(self.device).clone()


class _StepOut(NamedTuple):
    """What one control step of `make_batched_step` computes on the flat
    carry: the next state, the obs (B*N, D) before `obs_layout`, and the
    reward, terminated and truncated flags (B,)."""
    state: core.EnvState
    obs: torch.Tensor
    reward: torch.Tensor
    term: torch.Tensor
    trunc: torch.Tensor


def batched_step_graphable(device: torch.device, task) -> bool:
    """Whether `make_batched_step`'s control step runs as the replay of
    CUDA graphs: on a CUDA device, for a task whose resets are
    deterministic (a reset-noise stream draws on the host every
    `ResetNoise.BLOCK` steps, which a capture would freeze)."""
    return device.type == "cuda" and not core.has_reset_noise(task)


def _order(t: torch.Tensor) -> tuple:
    """What an operation that reads `t` sees of its layout: the device,
    dtype, shape and the strides of the dims longer than one."""
    strides = () if t.numel() == 0 else tuple(
        s for s, k in zip(t.stride(), t.shape) if k > 1)
    return t.device, t.dtype, t.shape, strides


class _StepGraph:
    """`make_batched_step`'s control step (`body`) captured as
    `utils.graphs.Segments`: CUDA graphs of the step's PyTorch operations,
    with its hand-written kernels launched eagerly between them.

    The graphs read the state and the action from static tensors, write
    the next state over the state (the auto-reset's selects, `body`'s
    `into`) and keep the obs, reward and flags in their pool.  The static
    state is laid out as the eager step's results, so the graphs compute
    what the eager step computes on such inputs (the step's reductions
    follow their inputs' order of strides).  A replay copies the action
    in, replays, and copies the results out into fresh tensors, one
    `_foreach_copy_` a dtype: a returned tensor is never written again.
    The state comes in by one copy a leaf, or by none where the caller
    passes back the state that the last replay returned, unwritten since,
    which the static state holds."""

    def __init__(self, segments, action, out: _StepOut):
        self.segments, self.action, self.out = segments, action, out
        self._state = core.leaves(out.state)
        self._outs = core.leaves(out)
        by_dtype = {}
        for i, t in enumerate(self._outs):
            by_dtype.setdefault(t.dtype, []).append(i)
        self._by_dtype = list(by_dtype.values())
        # (the state the static state holds, its leaves with their versions)
        self._fed = None

    @classmethod
    def capture(cls, body, flat: core.EnvState, a: torch.Tensor):
        """(the call's result; the graph of the step): the step runs
        eagerly on a side stream (the warm-up), its results are copied
        into the static state (every copy the capture makes), then the
        capture."""
        with torch.cuda.device(a.device):
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side), torch.no_grad():
                result = body(flat, a)
                state = core.map_leaves(torch.empty_like, result.state)
                action = a.clone(memory_format=torch.contiguous_format)
                for dst, src in zip(core.leaves(state),
                                    core.leaves(result.state)):
                    dst.copy_(src)
                with graphs.Segments() as segments:
                    got = body(state, action, into=state)
                    for dst, src in zip(core.leaves(state),
                                        core.leaves(got.state)):
                        dst.copy_(src)
            here.wait_stream(side)
            for t in core.leaves(result) + core.leaves(state) + [action]:
                t.record_stream(here)
        return result, cls(segments, action, got._replace(state=state))

    def accepts(self, flat: core.EnvState, action) -> bool:
        """Whether a call can replay: the action a contiguous float32
        tensor of the static action's size on its device that needs no
        gradient, and the state the one the static state holds or laid
        out as it."""
        want = self.action
        if not (isinstance(action, torch.Tensor)
                and action.dtype == want.dtype
                and action.device == want.device
                and action.numel() == want.numel()
                and action.is_contiguous() and not action.requires_grad):
            return False
        if self._holds(flat):
            return True
        leaves = core.leaves(flat)
        return len(leaves) == len(self._state) and all(
            not x.requires_grad and _order(x) == _order(v)
            for x, v in zip(leaves, self._state))

    def __call__(self, flat: core.EnvState, a: torch.Tensor) -> _StepOut:
        if not self._holds(flat):
            for dst, src in zip(self._state, core.leaves(flat), strict=True):
                dst.copy_(src)
        self.action.copy_(a)
        self.segments.replay()
        fresh = [torch.empty_like(t) for t in self._outs]
        for group in self._by_dtype:
            torch._foreach_copy_([fresh[i] for i in group],
                                 [self._outs[i] for i in group])
        leaves = iter(fresh)
        out = core.map_leaves(lambda _: next(leaves), self.out)
        state = core.leaves(out.state)
        self._fed = None if state[0].is_inference() else (
            out.state, [(t, t._version) for t in state])
        return out

    def _holds(self, flat) -> bool:
        fed = self._fed
        return fed is not None and flat is fed[0] and all(
            t._version == v for t, v in fed[1])


def _flat_reset(cfg, task, num_envs: int, device):
    """The deterministic reset tiled to the flat (B*N, k) carry, and its
    obs (B, N, D).  Computed once per call: deterministic resets are a
    constant."""
    s1 = core.initial_state(cfg, task, device=device)
    obs1 = task.compute_obs(cfg, s1)
    tile = lambda x: x.repeat((num_envs,) + (1,) * (x.dim() - 1))
    s1 = s1._replace(
        action_buffer=s1.action_buffer.flatten(1),         # (N, BUF*A)
        step_counter=torch.zeros((1,), dtype=torch.int32, device=device))
    return core.map_leaves(tile, s1), obs1.expand((num_envs,) + obs1.shape)


def _rank_envs(num_envs: int, device, mesh):
    """(device, this rank's envs, its (lo, hi) env columns or None): the
    whole batch on `device`, or under `mesh` the rank's columns of the
    global `num_envs` on the mesh's device."""
    if mesh is None:
        return resolve_device(device), num_envs, None
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    lo, hi = mesh.env_range(num_envs)
    return mesh.device, hi - lo, (lo, hi)


def make_batched_step(cfg: core.AviaryConfig, task, num_envs: int,
                      autoreset: bool = True, obs_layout: str = "drone",
                      device=None, mesh=None):
    """Build step_fn over batched EnvState with a flattened (B*N, ...) carry.

    Returns (reset_fn, step_fn); reset_fn(seed) -> (state, obs);
    step_fn(state, action (B, N, A)) -> (state, obs, reward, term, trunc)
    with per-env leading axes on the outputs (reward/term/trunc (B,)).

    The state is float32 and every control step goes through ONE kernel.
    DYN physics: `pid_dyn_ctrl_step` for a task with PID-family actions,
    `dyn_ctrl_step` otherwise.  The PYB family: `env_ctrl_step`, with the
    PID tick in-kernel for PID-family actions, for any
    `cfg.solver_iterations`.  (float64 parity runs use `core.step`.)

    A task with reset noise: reset_fn(seed) starts a `ResetNoise` stream
    from `seed` and randomizes the reset from its first draw; every
    control step then takes the next draw, randomizes the reset of every
    env with it and keeps that where an env is done (no host sync on
    `done`).  The stream lives in this closure (an EnvState carries no
    generator; `step_fn.reset_noise()` returns it, None for a
    deterministic task); before the first reset_fn it is seed 0's.
    `step_fn.use_reset_noise(stream)` hands the closure a stream that a
    caller kept (the trainer's `TrainState.reset_noise`), so that a reset
    in between (an evaluation) does not move the caller's draws.

    On a CUDA device, for a deterministic task (`batched_step_graphable`),
    the control step runs as the replay of CUDA graphs (`_StepGraph`):
    the first call runs the step eagerly and captures it; every later call
    whose state is laid out as the step's own results replays it (a copy of
    the action in, the graphs of the PyTorch operations with the physics
    and render kernels launched eagerly between them, the results copied
    out into fresh tensors), bit for bit the eager step.  The CPU, a task with reset
    noise and any other call run the same step eagerly.  Each kernel's
    launch keeps its wrapper's span and `launches` count on every call.

    Each call of step_fn is a span `env.batched_step`
    (`utils.profiling.span`), whose attribute `graphed` is 1 on a replay
    and 0 on an eager call.

    obs_layout: "drone" -> obs (B, N, D) (reference per-drone layout);
    "flat" -> obs (B, N*D).

    mesh (`parallel.Mesh`): `num_envs` is the global batch, and this
    rank's reset and step cover its columns of it, B = num_envs /
    mesh.size envs on the mesh's device (refused where the ranks cannot
    split it evenly).  Each control step is this rank's one launch; no
    collective.  A task with reset noise takes the rank's rows of the
    GLOBAL batch's draws, so its envs reset as they do in one process.
    """
    if obs_layout not in ("drone", "flat"):
        raise ValueError(f"unknown obs_layout {obs_layout!r}")
    n = cfg.num_drones
    device, num_envs, cols = _rank_envs(num_envs, device, mesh)
    rows = None if cols is None else (cols[0] * n, cols[1] * n)
    global_bn = (num_envs if cols is None else mesh.size * num_envs) * n
    bn = num_envs * n
    buf_len, act_dim = task.action_buffer_shape(cfg)
    # ask the kernel for the 12-row obs block when the task consumes it (KIN;
    # RGB renders its obs from the state)
    want_obs12 = getattr(task, "obs", None) == ObservationType.KIN
    # PID-family actions: the cascaded PID and the substeps are ONE launch.
    # Embedded controllers are always CF2X (reference BaseRLAviary.py:76),
    # so this is exact for any dynamics model.
    fused_pid = (getattr(task, "act", None) in PID_FAMILY
                 and getattr(task, "_pid_targets", None) is not None)

    init_flat, init_obs = _flat_reset(cfg, task, num_envs, device)
    init_obs_flat = init_obs.reshape(bn, -1)               # (B*N, D)
    noisy = core.has_reset_noise(task)
    noise = ResetNoise(0, (global_bn,), device, rows) if noisy else None

    def _finalize_obs(obs):
        """Flat-hook obs (B*N, D) -> the requested output layout."""
        if obs_layout == "drone":
            return obs.reshape(num_envs, n, obs.shape[1])
        return obs.reshape(num_envs, n * obs.shape[1])

    def _reset_state():
        """The flat reset state and its obs (B*N, D): the constant, or for
        a task with reset noise the constant moved by the next draw."""
        if not noisy:
            return init_flat, init_obs_flat
        flat = task.randomize_reset(cfg, init_flat, noise.next())
        return flat, task.flat_post(cfg, flat, num_envs, n)[0]

    def reset_fn(seed: int = 0):
        # deterministic tasks: the seed is accepted for API parity, unused
        nonlocal noise
        if noisy:
            noise = ResetNoise(seed, (global_bn,), device, rows)
        flat, obs = _reset_state()
        return flat, _finalize_obs(obs)

    pyb = cfg.physics != Physics.DYN

    def _env_step(pid_params, dyn, ctrl_state, action_rows, last_rpm):
        """The PYB family: all drones of an env in one thread."""
        return kernel_env.env_ctrl_step(
            pid_params, cfg.drone, cfg.physics, n, cfg.steps_per_ctrl,
            cfg.pyb_dt, cfg.ctrl_dt, cfg.obstacles, dyn, ctrl_state,
            action_rows, last_rpm, want_obs12, cfg.solver_iterations)

    def _physics(flat: core.EnvState, flat_rpm: torch.Tensor):
        """Advance the physics on the flat carry -> (state, obs12 | None)."""
        dyn = DynState(pos=flat.pos, quat=flat.quat, vel=flat.vel,
                       rpy_rates=flat.rpy_rates, ang_v=flat.ang_v)
        if pyb:
            out, _, _, *obs12 = _env_step(None, dyn, None, flat_rpm,
                                          flat.last_rpm)
            obs12 = obs12[0] if obs12 else None
        else:
            out = kernel_dyn.dyn_ctrl_step(cfg.drone, dyn, cfg.steps_per_ctrl,
                                           cfg.pyb_dt, flat_rpm, want_obs12)
            out, obs12 = out if want_obs12 else (out, None)
        return flat._replace(
            pos=out.pos, quat=out.quat, vel=out.vel,
            rpy_rates=out.rpy_rates, ang_v=out.ang_v,
            last_rpm=flat_rpm), obs12

    def _pid_physics(flat: core.EnvState, a: torch.Tensor):
        """Setpoints as tensor code, then PID tick + physics in one launch;
        `last_rpm` is what the kernel's controller commanded."""
        tp, trpy, tv, trr = task._pid_targets(cfg, flat, a)
        dyn = DynState(pos=flat.pos, quat=flat.quat, vel=flat.vel,
                       rpy_rates=flat.rpy_rates, ang_v=flat.ang_v)
        if pyb:
            out, new_pid, rpm, *obs12 = _env_step(
                CF2X, dyn, flat.ctrl_state,
                torch.cat([tp, trpy, tv, trr], dim=-1), flat.last_rpm)
        else:
            out, new_pid, rpm, *obs12 = kernel_pid.pid_dyn_ctrl_step(
                CF2X, cfg.drone, dyn, flat.ctrl_state, cfg.steps_per_ctrl,
                cfg.pyb_dt, cfg.ctrl_dt, tp, trpy, tv, trr, want_obs12)
        return flat._replace(
            pos=out.pos, quat=out.quat, vel=out.vel,
            rpy_rates=out.rpy_rates, ang_v=out.ang_v,
            last_rpm=rpm, ctrl_state=new_pid), (obs12[0] if obs12 else None)

    def body(flat: core.EnvState, a: torch.Tensor, into=None) -> _StepOut:
        """One control step on the flat carry and the flat action (B*N,
        A).  `into` (an EnvState, or None): where the auto-reset's selects
        write the next state."""
        if buf_len > 0:
            flat = flat._replace(action_buffer=torch.cat(
                [flat.action_buffer[:, act_dim:], a], dim=-1))
        if fused_pid:
            flat, obs12 = _pid_physics(flat, a)
        else:
            rpm, flat = task._map_to_rpm(cfg, flat, a)
            flat, obs12 = _physics(flat, rpm)
        # hooks see the PRE-increment counter (reference
        # BaseAviary.py:376-382)
        obs, reward, term, trunc = task.flat_post(
            cfg, flat, num_envs, n, obs12=obs12)
        flat = flat._replace(
            step_counter=flat.step_counter + cfg.steps_per_ctrl)
        if not autoreset:
            return _StepOut(flat, obs, reward, term, trunc)
        done = torch.logical_or(term, trunc)                   # (B,)
        done_bn = done.repeat_interleave(n)                    # (B*N,)

        def pick(i, nxt, dst=None):
            # per-drone leaves (B*N, k) reset by drone row, the counter
            # (B,) by env
            d = done_bn if nxt.dim() > 1 else done
            return torch.where(
                d.reshape((-1,) + (1,) * (nxt.dim() - 1)), i, nxt, out=dst)
        reset_flat, reset_obs = _reset_state()
        if into is None:
            flat = core.map_leaves(pick, reset_flat, flat)
        else:
            flat = core.map_leaves(pick, reset_flat, flat, into)
        obs = torch.where(done_bn[:, None], reset_obs, obs)
        return _StepOut(flat, obs, reward, term, trunc)

    graphable = batched_step_graphable(device, task)
    graph = None    # the step's `_StepGraph`, from the first graphable call

    def step_fn(flat: core.EnvState, action):
        nonlocal graph
        replay = graph is not None and graph.accepts(flat, action)
        with span("env.batched_step", graphed=int(replay)):
            a = torch.as_tensor(action, dtype=torch.float32,
                                device=device).reshape(bn, act_dim)
            if replay:
                out = graph(flat, a)
            elif graphable and graph is None:
                out, graph = _StepGraph.capture(body, flat, a)
            else:
                out = body(flat, a)
            return (out.state, _finalize_obs(out.obs), out.reward, out.term,
                    out.trunc)

    def use_reset_noise(stream: ResetNoise) -> None:
        nonlocal noise
        noise = stream

    step_fn.reset_noise = lambda: noise
    step_fn.use_reset_noise = use_reset_noise
    return reset_fn, step_fn


def fused_spec(cfg: core.AviaryConfig, task) -> kernel_fused.FusedSpec:
    """Check that (cfg, task) is eligible for the fused kernel and return
    its constants, the reset state of one env among them.

    Eligibility (raises ValueError): KIN observations, any action type
    (PID-family actions carry the embedded DSL-PID state as 9 extra
    in-kernel rows per drone), deterministic resets, a task implementing
    `row_post` (and optionally `row_extra_obs`), at most 8 drones and 8
    obstacles.  DYN and all PYB-family physics modes are supported (sphere
    and box obstacles included), with any `cfg.solver_iterations`.
    """
    if getattr(task, "obs", None) != ObservationType.KIN:
        raise ValueError("fused rollout requires KIN observations")
    if getattr(task, "row_post", None) is None:
        raise ValueError("task has no row_post hook")
    if core.has_reset_noise(task):
        # as in the JAX package (its fast.py:450-452)
        raise ValueError("fused rollout requires deterministic resets")
    s1, _, _ = core.reset(cfg, task, device="cpu")
    flat16_1 = torch.cat(
        [s1.pos, s1.quat, s1.vel, s1.rpy_rates, s1.ang_v], dim=-1)  # (N, 16)
    return kernel_fused.FusedSpec(
        cfg, task, tuple(tuple(row) for row in flat16_1.tolist()))


def make_fused_rollout(cfg: core.AviaryConfig, task, num_envs: int,
                       obs_layout: str = "flat", device=None, mesh=None):
    """Fully-fused rollout stepping: ONE kernel launch and a ONE-buffer
    carry per control step (ops/kernel_fused.py) — physics, action buffer,
    task reward/termination, obs assembly, and auto-reset all in-kernel.

    Returns (reset_fn, step_fn): reset_fn() -> (carry, obs);
    step_fn(carry, action (B, N, A)) -> (carry, obs, reward, term, trunc),
    in a span `env.fused_step` (`utils.profiling.span`).
    The carry is an opaque (RC, B) float32 row block (columns = envs); use
    make_batched_step for an inspectable EnvState carry.

    obs_layout: "flat" (B, N*D), "drone" (B, N, D), or "rows" (N*D, B), the
    kernel's own layout; the first two are transposed views, not copies.

    Eligibility is `fused_spec`'s; fallback is NOT automatic.

    mesh (`parallel.Mesh`): `num_envs` is the global batch, and this
    rank's carry holds its columns of it, B = num_envs / mesh.size envs
    on the mesh's device (refused where the ranks cannot split it
    evenly).  The kernel runs one thread an (env, drone), so it asks for
    no other divisor (the JAX package's 128 x mesh.size is the TPU's lane
    tile).
    """
    if obs_layout not in ("flat", "drone", "rows"):
        raise ValueError(f"unknown obs_layout {obs_layout!r}")
    spec = fused_spec(cfg, task)
    device, num_envs, _ = _rank_envs(num_envs, device, mesh)
    n, act_dim, buf_rows = spec.n, spec.act_dim, spec.buf_rows
    bn = num_envs * n
    obs_dim = spec.obs_rows_per
    init16 = np.asarray(spec.init16, np.float32)               # (N, 16)
    obs1 = core.reset(cfg, task, device="cpu")[1].reshape(1, n * obs_dim)

    def reset_fn(seed: int = 0):
        # deterministic: the seed is accepted for API parity and unused
        tiled = np.tile(init16, (num_envs, 1))                 # (B*N, 16)
        leaves = {
            "pos": tiled[:, 0:3], "quat": tiled[:, 3:7],
            "vel": tiled[:, 7:10], "rpy_rates": tiled[:, 10:13],
            "ang_v": tiled[:, 13:16],
            "last_rpm": np.zeros((bn, 4), np.float32),
            "action_buffer": np.zeros((bn, buf_rows), np.float32),
            "pid": np.zeros((bn, kernel_fused.PR), np.float32),
            "step_counter": np.zeros((num_envs,), np.float32),
        }
        carry = kernel_fused.pack_carry(leaves, n, buf_rows, num_envs,
                                        task.act, device)
        obs = obs1.to(device).repeat(num_envs, 1)
        if obs_layout == "drone":
            obs = obs.reshape(num_envs, n, obs_dim)
        elif obs_layout == "rows":
            obs = obs.t().contiguous()
        return carry, obs

    def step_fn(carry, action):
        with span("env.fused_step"):
            # (B, N, A) -> (N*A, B) drone-major action rows
            a_rows = torch.as_tensor(action, dtype=torch.float32,
                                     device=device) \
                .reshape(num_envs, n * act_dim).t().contiguous()
            carry, outs = kernel_fused.fused_env_step(spec, carry, a_rows)
            return (carry,) + kernel_fused.unpack_outs(
                outs, n, buf_rows, obs_layout, spec.n_extra)

    return reset_fn, step_fn
