"""PPO on the card: rollout through the env kernels, GAE, clipped updates.

Counterpart of the JAX package's `rl/ppo.py`, with the same surface:
`PPOConfig` (the same fields and defaults), `Transition`, `TrainState` and
`make_train(...) -> (init, update, evaluate, network)` with `update.many`
and `update.env_path`.  Where the JAX package scans one jitted program on
the device, an update here is a Python loop that enqueues work on the
card: one policy forward pass and ONE env-kernel launch per control step
(`envs.fast.make_fused_rollout`, the fused env step, when `fused_spec`
admits the (cfg, task); else `make_batched_step`), then the GAE recursion
and `update_epochs x num_minibatches` optimizer steps (`MinibatchSteps`:
on the card, where no collective lies inside the step, the replays of
one CUDA graph of the step).  Nothing inside a rollout step or a
minibatch step reads a value back to the host: the metrics come back as
0-d tensors on the device.

The optimizer is written in optax's form, as the JAX package chains it:
`clip_by_global_norm(max_grad_norm)` (leave the gradient as it is where
its global norm is below the limit, else scale it by limit / norm), then
Adam with betas (0.9, 0.999) and eps 1e-5 outside the square root, at a
learning rate that `anneal_lr` takes linearly to 0 over every optimizer
step of the run.

RGB observations (each drone's 48x64x4 camera image, rendered by one
kernel launch a control step) get the NatureCNN actor-critic
(`models/cnn.py`), as in the JAX package; its convolutions, forward and
backward, run in IEEE float32 on the card, not TF32.

`PPOConfig.compute_dtype` ("bfloat16") builds the MLP with bf16 layers
over float32 master weights, as the JAX package does; the CNN has none.
Everything below `make_train` works on a leading member axis of K
policies, each on its own E envs of one K x E env: `make_train` is the
case K = 1, the population trainer (`rl/population.py`) stacks K
policies, and both run the same update (`make_update`) and evaluation
(`make_evaluate`).

`make_train(..., mesh=)` trains data-parallel over the ranks of a
`parallel.Mesh`: each rank steps its columns of the global env batch, the
policy and Adam's moments are replicated, and one update all-reduces the
advantage statistics and the gradient of each optimizer step, and its
metrics, so that it computes what one process computes on the global
batch (`make_update`).  The JAX package's `use_pallas` is TPU-only: the
kernels here run wherever the tensors lie.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, NamedTuple

import torch

from gym_pybullet_drones_tpu_torch.envs import core
from gym_pybullet_drones_tpu_torch.envs.fast import (
    make_batched_step, make_fused_rollout)
from gym_pybullet_drones_tpu_torch.models.cnn import (
    ActorCriticCNN, ieee_fp32_convs)
from gym_pybullet_drones_tpu_torch.models.mlp import (
    ActorCritic, gaussian_entropy, gaussian_log_prob)
from gym_pybullet_drones_tpu_torch.parallel.distributed import (
    global_env_batch)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ObservationType
from gym_pybullet_drones_tpu_torch.utils.profiling import span

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 64
    rollout_steps: int = 128       # env steps per update, per env
    num_minibatches: int = 4
    update_epochs: int = 10
    total_timesteps: int = 100_000
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.0
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    hidden: tuple = (64, 64)       # MLP tower widths (ActorCritic)
    log_std_init: float = 0.0      # initial policy exploration (log sigma)
    # the MLP's layers compute in this dtype ('bfloat16'); None = float32
    compute_dtype: str | None = None
    # SB3-exact minibatch semantics: shuffle the flattened (T*E) batch each
    # epoch.  Default False = time-axis minibatching (random timestep
    # subsets, all envs per minibatch), the JAX package's default.
    sb3_minibatching: bool = False

    def __post_init__(self):
        if self.rollout_steps % self.num_minibatches != 0:
            raise ValueError(
                "rollout_steps must be divisible by num_minibatches "
                f"(got {self.rollout_steps} / {self.num_minibatches})")

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_steps

    @property
    def num_updates(self) -> int:
        return max(1, self.total_timesteps // self.batch_size)


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


class AdamState(NamedTuple):
    """optax's `ScaleByAdamState`: the step count (a host int: the bias
    corrections and the schedule are computed on the host, a table of
    them an update) and the moments."""
    count: int
    mu: list
    nu: list


class TrainState(NamedTuple):
    """`network` is the policy module, trained in place: the TrainState an
    update returns holds the same module and moment tensors as the one it
    was given.  `generator` (on the training device) draws the rollout
    noise and the minibatch permutations, where the JAX package splits
    `key`.  `reset_noise` is the batched env's reset-noise stream
    (`envs/fast.py` `ResetNoise`) for a task with reset noise, else None:
    where the JAX package's env state carries its key, the update hands
    this stream to the env and advances it in place, as the generator."""
    network: torch.nn.Module
    opt_state: AdamState
    env_state: Any             # fused carry (RC, E), or the flat EnvState
    last_obs: torch.Tensor     # (num_envs, obs_flat)
    generator: torch.Generator
    update_idx: int
    reset_noise: Any = None    # ResetNoise | None


class Draws(NamedTuple):
    """The random numbers of one update, for `update(ts, draws)`: the
    rollout noise (rollout_steps, num_envs, act_dim) and one permutation
    per epoch, (update_epochs, rollout_steps), or (update_epochs,
    rollout_steps * num_envs) under `sb3_minibatching`."""
    noise: torch.Tensor
    perms: torch.Tensor


def adam_init(params) -> AdamState:
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def clip_adam_step(params, grads, state: AdamState, lr,
                   max_grad_norm: float, corrections=None) -> AdamState:
    """One step of optax's `chain(clip_by_global_norm(max_grad_norm),
    adam(lr, eps=1e-5))` for K policies, applied to `params` in place
    (under no_grad).  Every tensor has a leading member axis (a single
    policy is K = 1) and each member's gradient is clipped by its own
    global norm, as optax's clip is under `jax.vmap`; Adam is
    elementwise.

    `lr` and `corrections`, Adam's bias corrections (1 - b1 ** n,
    1 - b2 ** n) of this step n = count + 1 (None: from the count, on the
    host), are host floats or 0-d tensors on the device; the minibatch
    step passes tensors, which a captured graph reads at each replay."""
    K = grads[0].shape[0]
    g_norm = torch.linalg.vector_norm(
        torch.cat([g.reshape(K, -1) for g in grads], dim=1), dim=1)
    keep = g_norm < max_grad_norm
    shape = lambda x, g: x.reshape((K,) + (1,) * (g.dim() - 1))
    grads = [torch.where(shape(keep, g), g,
                         g / shape(g_norm, g) * max_grad_norm)
             for g in grads]
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, 1 - ADAM_B2)
    count = state.count + 1
    bc1, bc2 = bias_corrections(count) if corrections is None \
        else corrections
    mu_hat = torch._foreach_div(mu, bc1)
    den = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(mu_hat, den)
    # optax's order: the update scaled by -lr, then added
    torch._foreach_mul_(mu_hat, lr)
    with torch.no_grad():
        torch._foreach_sub_(params, mu_hat)
    return AdamState(count, mu, nu)


def bias_corrections(count: int) -> tuple:
    """Adam's bias corrections (1 - b1 ** count, 1 - b2 ** count) of
    optimizer step `count` (the first is 1), on the host."""
    return 1 - ADAM_B1 ** count, 1 - ADAM_B2 ** count


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule: `init_value` at step 0 to `end_value` at
    `transition_steps`, then constant; a host function of the step."""
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def learning_rate(ppo: PPOConfig):
    """The learning rate as a host function of the optimizer step count:
    `ppo.lr`, or under `anneal_lr` linear to 0 over every optimizer step
    of the run."""
    if ppo.anneal_lr:
        return linear_schedule(ppo.lr, 0.0, ppo.num_updates
                               * ppo.update_epochs * ppo.num_minibatches)
    return lambda count: ppo.lr


def compute_dtype_of(ppo: PPOConfig):
    """`PPOConfig.compute_dtype` as a torch dtype (None = float32)."""
    if ppo.compute_dtype is None:
        return None
    dtype = getattr(torch, str(ppo.compute_dtype), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {ppo.compute_dtype!r} is not a "
                         "torch floating dtype")
    return dtype


def make_env(env_cfg: core.AviaryConfig, task, num_members: int,
             num_envs: int, device, env_path: str | None, mesh=None):
    """The training env of K = `num_members` members of E = `num_envs`
    envs each, as ONE env of K x E envs (member k owns env columns
    [k*E, (k+1)*E); a single run is K = 1), with flat observations:
    (reset, step, path).  reset() -> (env_state, obs (K, E, obs_dim));
    step(env_state, action (K, E, act_dim)) -> (env_state, obs, reward,
    term, trunc), member-major (K, E, ...).  env_path None = the fused
    kernel where `fused_spec` admits (cfg, task), else the batched step;
    'fused' raises where the fused path is not admitted; 'batched' forces
    `make_batched_step`.  Under `mesh` these K x E envs are this rank's
    columns of a global env of K x E x mesh.size envs, on the mesh's
    device."""
    if env_path not in (None, "fused", "batched"):
        raise ValueError(f"env_path must be None|'fused'|'batched', "
                         f"got {env_path!r}")
    K, E, n_drones = num_members, num_envs, env_cfg.num_drones
    act_dim_per_drone = task.action_dim(env_cfg)
    obs_dim = n_drones * task.obs_dim(env_cfg)
    total = K * E * (1 if mesh is None else mesh.size)
    made = None
    if env_path != "batched":
        try:
            made = make_fused_rollout(env_cfg, task, total,
                                      obs_layout="flat", device=device,
                                      mesh=mesh) + ("fused",)
        except ValueError:
            if env_path == "fused":
                raise
    if made is None:
        made = make_batched_step(env_cfg, task, total, autoreset=True,
                                 obs_layout="flat", device=device,
                                 mesh=mesh) + ("batched",)
    env_reset, env_step, path = made

    def reset():
        env_state, obs = env_reset()
        return env_state, obs.reshape(K, E, obs_dim)

    def step(env_state, action):
        env_state, obs, reward, term, trunc = env_step(
            env_state, action.reshape(K * E, n_drones, act_dim_per_drone))
        return (env_state, obs.reshape(K, E, obs_dim),
                *(x.reshape(K, E) for x in (reward, term, trunc)))
    # the batched path's reset-noise stream (None on the fused path, which
    # refuses noise) and its setter, for `TrainState.reset_noise`
    step.reset_noise = getattr(env_step, "reset_noise", lambda: None)
    step.use_reset_noise = getattr(env_step, "use_reset_noise", None)
    return reset, step, path


def collect_rollout(net, step, env_state, obs, noise):
    """`len(noise)` control steps of the Gaussian policy: one forward pass
    and one env step each, nothing read back.  `step(env_state, action)`
    takes the policy's action as it comes out of `net`; `noise[t]` has the
    action's shape.  Returns (env_state, obs, traj, last_value), traj a
    `Transition` of tensors with a leading time axis."""
    steps = []
    with torch.no_grad():
        for t in range(len(noise)):
            mean, log_std, value = net(obs)
            action = mean + torch.exp(log_std) * noise[t]
            log_prob = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, term, trunc = step(env_state,
                                                            action)
            done = torch.logical_or(term, trunc).to(obs.dtype)
            steps.append((obs, action, log_prob, value, reward, done))
            obs = next_obs
        last_value = net(obs)[2]
    traj = Transition(*(torch.stack(x) for x in zip(*steps)))
    return env_state, obs, traj, last_value


def gae(traj: Transition, last_value, gamma: float, gae_lambda: float):
    """(advantages, returns) over the time axis, any trailing shape."""
    # done[t] marks that the state AFTER step t is a reset state, so the
    # bootstrap V(s_{t+1}) and the recursive GAE term are both masked by
    # (1 - done[t]) of the CURRENT transition.
    nonterminal = 1.0 - traj.done
    next_value = torch.cat([traj.value[1:], last_value[None]])
    delta = traj.reward + gamma * next_value * nonterminal - traj.value
    coef = gamma * gae_lambda * nonterminal
    gae_t = torch.zeros_like(last_value)
    advantages = [None] * len(delta)
    for t in reversed(range(len(delta))):
        gae_t = delta[t] + coef[t] * gae_t
        advantages[t] = gae_t
    advantages = torch.stack(advantages)
    return advantages, advantages + traj.value


def ranks_of(mesh):
    """(R, the sum over the ranks) of `mesh`: one rank, whose sum is the
    tensor itself, without one."""
    return (1, lambda x: x) if mesh is None else (mesh.size,
                                                  mesh.all_reduce)


def ppo_loss(net, batch: Transition, advantages, returns, ppo: PPOConfig,
             mesh=None):
    """The clipped PPO loss of K policies -> (total, (pg_loss, v_loss,
    entropy)), each (K,).  Every tensor has a leading member axis (a
    single policy is K = 1); each member's terms, the advantage
    normalisation among them, reduce over its own samples only.

    The samples are this rank's columns of a minibatch spread over the R
    ranks of `mesh` (all of it without one): the advantages are
    normalised by the whole minibatch's mean and ddof-0 std (two sums
    over the ranks: the sum, then the squared deviations; constants for
    the gradient), and each term is this rank's share of the mean (its
    own sum over the whole count; the entropy, the same on every rank,
    over R), which the caller sums over the ranks."""
    K = advantages.shape[0]
    ranks, reduce = ranks_of(mesh)
    count = advantages.shape[1] * ranks
    avg = lambda x: x.reshape(K, -1).sum(dim=1) / count
    mean, log_std, value = net(batch.obs)
    log_prob = gaussian_log_prob(mean, log_std, batch.action)
    ratio = torch.exp(log_prob - batch.log_prob)
    with torch.no_grad():
        adv_mean = reduce(advantages.sum(dim=1, keepdim=True)) / count
        adv_std = torch.sqrt(reduce(torch.square(
            advantages - adv_mean).sum(dim=1, keepdim=True)) / count)
    norm_adv = (advantages - adv_mean) / (adv_std + 1e-8)
    ent = gaussian_entropy(log_std).reshape(K, -1).mean(dim=1) / ranks
    pg1 = ratio * norm_adv
    pg2 = torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * norm_adv
    pg_loss = -avg(torch.minimum(pg1, pg2))
    v_loss = 0.5 * avg(torch.square(value - returns))
    total = pg_loss + ppo.vf_coef * v_loss - ppo.ent_coef * ent
    return total, (pg_loss, v_loss, ent)


class StepInputs(NamedTuple):
    """What one optimizer step reads, on the training device: the rollout
    as the minibatch gathers take it (`batch`, `advantages`, `returns`),
    the member indices `members` (K, 1), a row a step of the minibatch
    indices `takes` (S, K, mb_size) and of the host's scalars `scalars`
    (S, 3: the learning rate and Adam's two bias corrections), the step
    `cursor` (1,), and `aux` (S, 3, K), each step's loss terms."""
    batch: Transition
    advantages: torch.Tensor
    returns: torch.Tensor
    members: torch.Tensor
    takes: torch.Tensor
    scalars: torch.Tensor
    cursor: torch.Tensor
    aux: torch.Tensor


class _Captured(NamedTuple):
    key: tuple
    held: list              # the tensors whose storages `key` names
    inputs: StepInputs      # the static inputs the graph reads
    graph: Any              # torch.cuda.CUDAGraph


def step_graphable(device: torch.device, ranks: int) -> bool:
    """Whether the minibatch step runs as a CUDA graph: on a CUDA device,
    with no collective inside the step (a sharded loss all-reduces inside
    it, and gloo's all-reduce cannot be captured)."""
    return device.type == "cuda" and ranks == 1


def graph_key(net, opt_state: AdamState, traj: Transition, perms) -> tuple:
    """What a captured minibatch step holds for: the shapes and dtypes of
    the rollout and the permutations, the storages of the policy's
    parameters and buffers and of Adam's moments (a new `init`,
    `adam_init` or a checkpoint that replaces tensors captures again), and
    the float32 matmul precision, which the capture fixes."""
    return (tuple((x.shape, x.dtype) for x in (*traj, perms)),
            tuple(t.data_ptr() for t in _state_tensors(net, opt_state)),
            torch.get_float32_matmul_precision())


def _state_tensors(net, opt_state: AdamState) -> list:
    return [*net.parameters(), *net.buffers(), *opt_state.mu, *opt_state.nu]


class MinibatchSteps:
    """The `update_epochs x num_minibatches` optimizer steps of an update
    of K = `num_members` policies (`make_update`'s), as ONE step body
    (`_step`): the gather of the minibatch, `ppo_loss`, its gradient (its
    flattened all-reduce over the ranks of `loss_mesh`), the clip and
    Adam.  The body reads everything from a `StepInputs`, into which
    each update copies its rollout, its permutations' slices and its
    table of scalars (filled on the host, one copy): a step's row of
    each is picked by a cursor on the device that the body advances.

    Where `step_graphable` (a CUDA device, no collective in the step),
    the body is captured once a `graph_key` as a CUDA graph, whose static
    inputs those are, and replayed for every later step: the first step
    of a new key runs eagerly on a side stream (the warm-up, a real
    step), then the capture.  After the replays each parameter's and
    moment's `_version` is advanced (autograd cannot see a replay's
    writes).  Elsewhere every step calls the body eagerly."""

    def __init__(self, ppo: PPOConfig, num_members: int, lead,
                 loss_mesh=None):
        self.ppo, self.K, self.lead = ppo, num_members, lead
        self.loss_mesh = loss_mesh
        self.ranks, self.reduce = ranks_of(loss_mesh)
        self.steps = ppo.update_epochs * ppo.num_minibatches
        self.lr_at = learning_rate(ppo)
        self._captured = None   # _Captured | None

    def key(self, net, opt_state: AdamState, traj: Transition, perms):
        """The update's `graph_key`, or None where its steps run
        eagerly."""
        if not step_graphable(traj.obs.device, self.ranks):
            return None
        return graph_key(net, opt_state, traj, perms)

    def replays(self, key) -> int:
        """How many of the update of `key`'s steps are replays."""
        if key is None:
            return 0
        if self._captured is not None and self._captured.key == key:
            return self.steps
        return self.steps - 1

    def __call__(self, net, opt_state: AdamState, traj: Transition,
                 advantages, returns, perms, key=None):
        """The steps on the rollout (`traj`, `advantages`, `returns`; (T,
        K, E, ...)) with each member's permutations `perms` (K, epochs,
        n), eagerly where `key` is None: (opt_state, the mean of each
        step's loss terms (3, K))."""
        device = traj.obs.device
        params = list(net.parameters())
        views = [self.lead(p.detach()) for p in params]
        moments = AdamState(opt_state.count,
                            [self.lead(m) for m in opt_state.mu],
                            [self.lead(v) for v in opt_state.nu])
        mb_size = perms.shape[-1] // self.ppo.num_minibatches
        # row s = epoch * num_minibatches + i: that epoch's i-th slice
        takes = perms.reshape(self.K, self.steps, mb_size).transpose(0, 1)
        table = torch.tensor(
            [[self.lr_at(c), *bias_corrections(c + 1)] for c in
             range(opt_state.count, opt_state.count + self.steps)],
            dtype=opt_state.mu[0].dtype)
        if device.type == "cuda":
            # pinned, so that its copy does not wait for the device
            table = table.pin_memory()
        rollout = self._layout(traj, advantages, returns)
        if self._captured is not None and self._captured.key != key:
            self._captured = None    # its memory goes before more is taken
        inp = self._captured.inputs if self._captured is not None \
            else self._inputs(rollout, takes, table)
        batch, advantages, returns = rollout
        for dst, src in zip((*inp.batch, inp.advantages, inp.returns),
                            (*batch, advantages, returns)):
            dst.copy_(src)
        inp.takes.copy_(takes)
        inp.scalars.copy_(table, non_blocking=True)
        inp.cursor.zero_()
        if key is None:
            for _ in range(self.steps):
                self._step(net, params, views, moments, inp)
        else:
            with torch.cuda.device(device):
                self._replay(key, net, opt_state, params, views, moments,
                             inp)
        return (AdamState(opt_state.count + self.steps, opt_state.mu,
                          opt_state.nu), inp.aux.mean(dim=0))

    def _inputs(self, rollout, takes, table) -> StepInputs:
        """`StepInputs` of the update's shapes, on its device."""
        batch, advantages, returns = rollout
        device = advantages.device
        return StepInputs(
            Transition(*map(torch.empty_like, batch)),
            torch.empty_like(advantages), torch.empty_like(returns),
            torch.arange(self.K, device=device)[:, None],
            takes.new_empty(takes.shape),
            torch.empty(table.shape, dtype=table.dtype, device=device),
            torch.zeros(1, dtype=torch.long, device=device),
            advantages.new_empty((self.steps, 3, self.K)))

    def _layout(self, traj, advantages, returns):
        """The rollout as the gathers read it: (T, K, E, ...) as it is,
        or under sb3 minibatching each member's flattened (K, T*E, ...)."""
        if not self.ppo.sb3_minibatching:
            return traj, advantages, returns
        per_member = lambda x: x.transpose(0, 1).reshape(
            (self.K, -1) + x.shape[3:])
        return (Transition(*map(per_member, traj)), per_member(advantages),
                per_member(returns))

    def _gather(self, x, take, members):
        """Each member's minibatch `take` (K, mb_size) of `x`."""
        if self.ppo.sb3_minibatching:
            return x[members, take]
        # merge (T_mb, E) ENV-MAJOR within each member, as the JAX
        # package does
        return x[take, members].transpose(1, 2).reshape(
            (self.K, -1) + x.shape[3:])

    def _step(self, net, params, views, moments: AdamState,
              inp: StepInputs):
        """One optimizer step, the one `inp.cursor` points at, which it
        advances; its loss terms go to that row of `inp.aux`."""
        take = inp.takes.index_select(0, inp.cursor)[0]
        lr, bc1, bc2 = inp.scalars.index_select(0, inp.cursor)[0].unbind()
        gather = lambda x: self._gather(x, take, inp.members)
        with ieee_fp32_convs():
            # the policy's `forward` itself, not its hooks: a capture
            # would record a hook's work without doing it, and a replay
            # runs none
            total_loss, terms = ppo_loss(
                net.forward, Transition(*map(gather, inp.batch)),
                gather(inp.advantages), gather(inp.returns), self.ppo,
                self.loss_mesh)
            grads = torch.autograd.grad(total_loss.sum(), params)
        if self.ranks > 1:
            flat = self.reduce(torch.cat([g.reshape(-1) for g in grads]))
            grads = [x.view_as(g) for x, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        clip_adam_step(views, [self.lead(g) for g in grads], moments, lr,
                       self.ppo.max_grad_norm, (bc1, bc2))
        inp.aux.index_copy_(0, inp.cursor,
                            torch.stack([x.detach() for x in terms])[None])
        inp.cursor.add_(1)

    def _replay(self, key, net, opt_state, params, views, moments,
                inp: StepInputs):
        """The steps through the graph of `key`, reading `inp`: where the
        key is new, the first step eagerly on a side stream, then the
        capture."""
        first = 0
        if self._captured is None:
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self._step(net, params, views, moments, inp)
            here.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._step(net, params, views, moments, inp)
            self._captured = _Captured(key, _state_tensors(net, opt_state),
                                       inp, graph)
            first = 1
        for _ in range(first, self.steps):
            self._captured.graph.replay()
        if first < self.steps:
            # the replays' writes, which autograd cannot see
            for t in (*params, *opt_state.mu, *opt_state.nu):
                torch.autograd.graph.increment_version(t)


def make_update(ppo: PPOConfig, step, num_members: int, lead, mesh=None):
    """One PPO update of K = `num_members` policies, each on its own E
    envs of `step` (as `make_env` returns it).  `lead` views a parameter,
    its gradient or its Adam moment with a leading member axis: `x[None]`
    for a single policy, `x` itself for a `PopulationActorCritic`.

    run(net, opt_state, env_state, obs (K, E, D), draws, after_rollout)
    -> ((opt_state, env_state, obs), metrics): a rollout of
    `rollout_steps` control steps, its GAE, then `update_epochs x
    num_minibatches` optimizer steps (`MinibatchSteps`: a CUDA graph's
    replays on the card, where no collective lies inside the step).
    `draws` is a `Draws` with a leading member axis; each member gathers
    its minibatches with its own permutations, so member k's update is
    what a single run makes of its weights and draws.  The total loss is
    the SUM of the members' losses, so each member's gradient is its own.
    Every metric is (K,), a tensor of this update's own.

    `mesh`: one policy (K = 1) trained data-parallel over R ranks, `step`
    this rank's columns of the global env and `draws.noise` its columns
    of the global noise; the permutations are replicated.  Each optimizer
    step all-reduces the advantage statistics (`ppo_loss`) and the
    flattened gradient (one sum), then clips and steps Adam on every
    rank; the metrics are all-reduced once an update.  Under
    `sb3_minibatching` the rollout is gathered instead, once an update,
    and every rank runs the same full-batch steps with no collective.

    Spans (`utils.profiling.span`): `ppo.update` around the whole, and
    inside it `ppo.rollout`, `ppo.gae` (with the sb3 gather) and
    `ppo.optimize` (the optimizer steps and the metrics' reduce; its
    attribute `graph_steps` counts the steps that ran as a replay)."""
    K, T = num_members, ppo.rollout_steps
    # under sb3 minibatching every rank steps the gathered batch alone
    loss_mesh = None if ppo.sb3_minibatching else mesh
    ranks, reduce = ranks_of(loss_mesh)
    steps = MinibatchSteps(ppo, K, lead, loss_mesh)

    def run(net, opt_state: AdamState, env_state, obs, draws: Draws,
            after_rollout=None):
        # the phases' spans lie at the phase boundaries, outside the
        # per-step bodies
        with span("ppo.update"):
            # ---- rollout: traj leaves (T, K, E, ...) ----
            with span("ppo.rollout"):
                env_state, obs, traj, last_value = collect_rollout(
                    net, step, env_state, obs, draws.noise.transpose(0, 1))
            with span("ppo.gae"):
                advantages, returns = gae(traj, last_value, ppo.gamma,
                                          ppo.gae_lambda)
                if mesh is not None and ppo.sb3_minibatching:
                    # the flattened (T*E) shuffle mixes every rank's envs
                    traj = Transition(*(global_env_batch(mesh, x, 2)
                                        for x in traj))
                    advantages = global_env_batch(mesh, advantages, 2)
                    returns = global_env_batch(mesh, returns, 2)
            if after_rollout is not None:
                after_rollout()
            key = steps.key(net, opt_state, traj, draws.perms)
            with span("ppo.optimize", graph_steps=steps.replays(key)):
                opt_state, aux = steps(net, opt_state, traj, advantages,
                                       returns, draws.perms, key)
                metrics = summarize(traj, aux)
        return (opt_state, env_state, obs), metrics

    def summarize(traj, aux):
        """The update's metrics from the rollout and the steps' mean loss
        terms (3, K)."""
        E = traj.obs.shape[2]
        # this rank's shares of the means, summed over the ranks in one go
        means = torch.stack([traj.reward.sum(dim=(0, 2)),
                             traj.value.sum(dim=(0, 2))]) / (T * E * ranks)
        means, aux = reduce(torch.cat([means, aux])).split([2, 3])
        return {
            "mean_reward": means[0],
            "mean_value": means[1],
            "pg_loss": aux[0],
            "v_loss": aux[1],
            "entropy": aux[2],
        }
    return run


def chain_updates(update):
    """update.many(ts, n): `n` chained updates, every metric stacked on a
    trailing (n,) axis."""
    def many(ts: TrainState, num_updates: int):
        history = []
        for _ in range(num_updates):
            ts, metrics = update(ts)
            history.append(metrics)
        return ts, {k: torch.stack([m[k] for m in history], dim=-1)
                    for k in history[0]}
    return many


def episode_steps(env_cfg: core.AviaryConfig, task) -> int:
    """The reference episode: episode_len_sec * ctrl_freq + 2 control
    steps (QUIRKS.md #11), `evaluate`'s default."""
    return int(getattr(task, "episode_len_sec", 8.0) * env_cfg.ctrl_freq) \
        + 2


def make_evaluate(env_cfg: core.AviaryConfig, task, template, reset, step):
    """The evaluation of K policies on `make_env`'s (reset, step)."""
    def evaluate(params_or_network, generator=None,
                 num_steps: int | None = None, episodic: bool = False):
        """The deterministic policy (its mean) for `num_steps` control
        steps from a reset: the summed reward per env, (K, E), on the
        device.

        `params_or_network` is a module or a state_dict for a copy of
        `template`.  `generator` is accepted for the JAX signature and
        unused.  episodic=True stops each env's sum at its first
        terminated/truncated signal (SB3's EvalCallback).  The reference
        episode lasts episode_len_sec * ctrl_freq + 2 control steps
        (QUIRKS.md #11), the default num_steps."""
        if isinstance(params_or_network, torch.nn.Module):
            net = params_or_network
        else:
            net = copy.deepcopy(template)
            net.load_state_dict(params_or_network)
        if num_steps is None:
            num_steps = episode_steps(env_cfg, task)
        env_state, obs = reset()
        rewards, alive = [], None
        with torch.no_grad():
            for _ in range(num_steps):
                env_state, obs, reward, term, trunc = step(env_state,
                                                           net(obs)[0])
                if episodic:
                    if alive is not None:
                        reward = torch.where(alive, reward, 0.0)
                    alive = ~(term | trunc) if alive is None \
                        else alive & ~(term | trunc)
                rewards.append(reward)
        return torch.stack(rewards).sum(dim=0)
    return evaluate


def make_arrival_rate(env_cfg: core.AviaryConfig, task, num_envs: int,
                      horizon: int, device=None):
    """The routing task's success metric, the all-arrivals rate: the share
    of `num_envs` episodes in which EVERY drone reaches its destination
    (`terminated` fires) within `horizon` control steps under the policy
    mean; the JAX package's `scripts/train_to_threshold.py --routing`
    evaluator.

    The envs run `make_batched_step(autoreset=False, obs_layout="flat")`
    from the task's reset, so an env that has arrived flies on and counts
    once.  Returns rate_fn(network) -> (rate, ever, state): the rate as a
    0-d tensor, each env's arrival flag (num_envs,) and the envs' final
    flat state, all on the device; nothing inside the loop reads back.
    `device`: None = the CUDA card."""
    reset, step = make_batched_step(env_cfg, task, num_envs,
                                    autoreset=False, obs_layout="flat",
                                    device=device)
    n, act_dim = env_cfg.num_drones, task.action_dim(env_cfg)

    def rate_fn(network: torch.nn.Module):
        state, obs = reset()
        ever = torch.zeros(num_envs, dtype=torch.bool, device=obs.device)
        with torch.no_grad():
            for _ in range(horizon):
                mean = network(obs)[0]
                state, obs, _, term, _ = step(state,
                                              mean.reshape(-1, n, act_dim))
                ever = ever | term
        return ever.float().mean(), ever, state
    return rate_fn


def make_train(env_cfg: core.AviaryConfig, task, ppo: PPOConfig,
               device=None, network: torch.nn.Module | None = None,
               env_path: str | None = None, mesh=None):
    """Build (init, update, evaluate, network) for PPO on (cfg, task).

    init(generator) -> TrainState: the env reset and, unless `network` was
    given, a fresh `ActorCritic` (layers in `ppo.compute_dtype`; an
    `ActorCriticCNN` for RGB observations, which has no compute dtype)
    whose orthogonal init is seeded from `generator` (which lives on the
    training device and goes on to draw the update's noise).  A given
    `network` is copied to the device as it is.  The returned `network` is
    that module, or else a fresh one of the run's shape (seed 0) into which
    `evaluate` loads a state_dict.

    update(ts, draws=None, after_rollout=None) -> (ts, metrics): one
    rollout of `rollout_steps` control steps and `update_epochs x
    num_minibatches` optimizer steps, `make_update`'s for one member;
    metrics are 0-d device tensors.  `draws` (a `Draws`) replaces the
    random numbers drawn from `ts.generator`, so that an update can be
    held against the JAX package's on the same draws.  `after_rollout`, if
    given, is called with no argument once the rollout and its GAE are
    enqueued (`chip_smoke.py` times the two phases so).  update.many(ts,
    k) chains k updates, metrics stacked on a (k,) axis.  update.env_path
    is 'fused' or 'batched'.

    evaluate(params_or_network, generator=None, num_steps=None,
    episodic=False) -> the summed reward per env, (num_envs,), on the
    device (`make_evaluate`).

    device: None = the CUDA card (raises without one); "cpu" runs the
    kernels' plain versions.  env_path: as `make_env` takes it.

    mesh (`parallel.Mesh`): data-parallel training over its ranks, on the
    mesh's device.  `init` resets this rank's envs only and returns its
    shard of the TrainState that one process starts from: its env columns
    and their rows of the reset noise, the policy and Adam's moments
    replicated (`parallel.gather_train_state` assembles the global one;
    `parallel.shard_train_state` cuts a global one, e.g. a single
    process's, the same way).  `update` takes the shard (update.mesh is
    the mesh).  `draws` are the global draws (every rank draws them from
    the replicated generator and keeps its noise columns).  `evaluate`
    steps this rank's envs and gathers the returns: (num_envs,) on every
    rank.  `num_envs` must divide evenly over the ranks.
    """
    compute_dtype = compute_dtype_of(ppo)
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        device = mesh.device
    device = resolve_device(device)
    rgb = getattr(task, "obs", None) == ObservationType.RGB
    n_drones = env_cfg.num_drones
    if rgb and network is None and n_drones != 1:
        raise ValueError("the CNN policy reads one drone's image: RGB "
                         "training takes one drone an env")
    act_dim = n_drones * task.action_dim(env_cfg)
    obs_dim = n_drones * task.obs_dim(env_cfg)
    T, E = ppo.rollout_steps, ppo.num_envs
    lo, hi = (0, E) if mesh is None else mesh.env_range(E)
    reset, step, env_path = make_env(env_cfg, task, 1, hi - lo, device,
                                     env_path, mesh)

    def fresh_network(generator: torch.Generator) -> torch.nn.Module:
        # the JAX package's `key, sub = split(key); network.init(sub)`: the
        # init's CPU generator is seeded from the training generator
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                                 device=generator.device))
        if rgb:
            return ActorCriticCNN(
                act_dim,
                generator=torch.Generator().manual_seed(seed)).to(device)
        return ActorCritic(
            obs_dim, act_dim, hidden=tuple(ppo.hidden),
            log_std_init=ppo.log_std_init, compute_dtype=compute_dtype,
            generator=torch.Generator().manual_seed(seed)).to(device)

    template = network if network is not None \
        else fresh_network(torch.Generator(device).manual_seed(0))

    def init(generator: torch.Generator) -> TrainState:
        if generator.device.type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the training on {device}")
        env_state, obs = reset()
        net = fresh_network(generator) if network is None \
            else copy.deepcopy(network).to(device)
        return TrainState(
            network=net, opt_state=adam_init(list(net.parameters())),
            env_state=env_state, last_obs=obs[0],
            generator=generator, update_idx=0,
            reset_noise=step.reset_noise())

    def _draws(generator) -> Draws:
        noise = torch.randn((T, E, act_dim), generator=generator,
                            device=device)
        n = T * E if ppo.sb3_minibatching else T
        perms = torch.stack([
            torch.randperm(n, generator=generator, device=device)
            for _ in range(ppo.update_epochs)])
        return Draws(noise, perms)

    run = make_update(ppo, step, 1, lambda x: x[None], mesh)

    def update(ts: TrainState, draws: Draws | None = None,
               after_rollout=None):
        if ts.last_obs.shape[0] != hi - lo:
            raise ValueError(f"a TrainState of {ts.last_obs.shape[0]} envs "
                             f"for an update of {hi - lo} (a sharded "
                             "update takes its own init's shard)")
        if draws is None:
            draws = _draws(ts.generator)
        if ts.reset_noise is not None:
            step.use_reset_noise(ts.reset_noise)
        (opt_state, env_state, obs), metrics = run(
            ts.network, ts.opt_state, ts.env_state, ts.last_obs[None],
            Draws(draws.noise[None, :, lo:hi], draws.perms[None]),
            after_rollout)
        return ts._replace(opt_state=opt_state, env_state=env_state,
                           last_obs=obs[0],
                           update_idx=ts.update_idx + 1), \
            {k: v[0] for k, v in metrics.items()}

    evaluate_members = make_evaluate(env_cfg, task, template, reset, step)

    def evaluate(params_or_network, generator=None,
                 num_steps: int | None = None, episodic: bool = False):
        """`make_evaluate`'s evaluation of the one policy: (num_envs,)."""
        returns = evaluate_members(params_or_network, generator, num_steps,
                                   episodic)[0]
        return returns if mesh is None else global_env_batch(mesh, returns)

    update.many = chain_updates(update)
    update.env_path = env_path
    update.mesh = mesh
    return init, update, evaluate, template
