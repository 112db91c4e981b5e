"""PPO on the card: rollout through the env kernels, GAE, clipped updates.

Counterpart of the JAX package's `rl/ppo.py`, with the same surface:
`PPOConfig` (the same fields and defaults), `Transition`, `TrainState` and
`make_train(...) -> (init, update, evaluate, network)` with `update.many`
and `update.env_path`.  Where the JAX package scans one jitted program on
the device, an update here is a Python loop that enqueues work on the
card: one policy forward pass and ONE env-kernel launch per control step
(`envs.fast.make_fused_rollout`, the fused env step, when `fused_spec`
admits the (cfg, task); else `make_batched_step`), then the GAE recursion
and `update_epochs x num_minibatches` optimizer steps.  Nothing inside a
rollout step or a minibatch step reads a value back to the host: the
metrics come back as 0-d tensors on the device.

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

The JAX package's `mesh` and `use_pallas` arguments are TPU-only and are
not ported (ROADMAP.md queue 1, item 16); its bf16 `compute_dtype` waits
for item 18.
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
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ObservationType

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
    # 'bfloat16' Dense layers in the JAX package; not ported (item 18)
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
    corrections and the schedule are host scalars) and the moments."""
    count: int
    mu: list
    nu: list


class TrainState(NamedTuple):
    """`network` is the policy module, trained in place: the TrainState an
    update returns holds the same module and moment tensors as the one it
    was given.  `generator` (on the training device) draws the rollout
    noise and the minibatch permutations, where the JAX package splits
    `key`."""
    network: torch.nn.Module
    opt_state: AdamState
    env_state: Any             # fused carry (RC, E), or the flat EnvState
    last_obs: torch.Tensor     # (num_envs, obs_flat)
    generator: torch.Generator
    update_idx: int


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


def clip_adam_step(params, grads, state: AdamState, lr: float,
                   max_grad_norm: float) -> AdamState:
    """One step of optax's `chain(clip_by_global_norm(max_grad_norm),
    adam(lr, eps=1e-5))`, applied to `params` in place (under no_grad)."""
    g_norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
    keep = g_norm < max_grad_norm
    grads = [torch.where(keep, g, g / g_norm * max_grad_norm) for g in grads]
    mu, nu = state.mu, state.nu
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, 1 - ADAM_B2)
    count = state.count + 1
    mu_hat = torch._foreach_div(mu, 1 - ADAM_B1 ** count)
    den = torch._foreach_div(nu, 1 - ADAM_B2 ** count)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    torch._foreach_div_(mu_hat, den)
    with torch.no_grad():
        torch._foreach_add_(params, mu_hat, alpha=-lr)
    return AdamState(count, mu, nu)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule: `init_value` at step 0 to `end_value` at
    `transition_steps`, then constant; a host function of the step."""
    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def make_train(env_cfg: core.AviaryConfig, task, ppo: PPOConfig,
               device=None, network: torch.nn.Module | None = None,
               env_path: str | None = None):
    """Build (init, update, evaluate, network) for PPO on (cfg, task).

    init(generator) -> TrainState: the env reset and, unless `network` was
    given, a fresh `ActorCritic` (an `ActorCriticCNN` for RGB observations)
    whose orthogonal init is seeded from `generator` (which lives on the
    training device and goes on to draw the update's noise).  A given
    `network` is copied to the device as it is.  The returned `network` is
    that module, or else a fresh one of the run's shape (seed 0) into which
    `evaluate` loads a state_dict.

    update(ts, draws=None, after_rollout=None) -> (ts, metrics): one
    rollout of `rollout_steps` control steps and `update_epochs x
    num_minibatches` optimizer steps; metrics are 0-d device tensors.  `draws` (a `Draws`)
    replaces the random numbers drawn from `ts.generator`, so that an
    update can be held against the JAX package's on the same draws.
    `after_rollout`, if given, is called with no argument once the rollout
    and its GAE are enqueued (`chip_smoke.py` times the two phases so).
    update.many(ts, k) chains k updates, metrics stacked on a leading (k,)
    axis.  update.env_path is 'fused' or 'batched'.

    device: None = the CUDA card (raises without one); "cpu" runs the
    kernels' plain versions.  env_path: None = fused where eligible, else
    batched; 'fused' raises where the fused path is not admitted;
    'batched' forces `make_batched_step`.
    """
    if env_path not in (None, "fused", "batched"):
        raise ValueError(f"env_path must be None|'fused'|'batched', "
                         f"got {env_path!r}")
    if ppo.compute_dtype is not None:
        raise NotImplementedError(
            "PPOConfig.compute_dtype is not ported yet: ROADMAP.md queue 1, "
            "item 18")
    device = resolve_device(device)
    rgb = getattr(task, "obs", None) == ObservationType.RGB
    n_drones = env_cfg.num_drones
    if rgb and network is None and n_drones != 1:
        raise ValueError("the CNN policy reads one drone's image: RGB "
                         "training takes one drone an env")
    act_dim_per_drone = task.action_dim(env_cfg)
    act_dim = n_drones * act_dim_per_drone
    obs_dim = n_drones * task.obs_dim(env_cfg)
    T, E = ppo.rollout_steps, ppo.num_envs

    # obs_layout="flat": the policy reads (E, N*D) observations as they are
    forced_path = env_path
    env_reset = env_step = None
    env_path = "batched"
    if forced_path != "batched":
        try:
            env_reset, env_step = make_fused_rollout(
                env_cfg, task, E, obs_layout="flat", device=device)
            env_path = "fused"
        except ValueError:
            if forced_path == "fused":
                raise
    if env_step is None:
        env_reset, env_step = make_batched_step(
            env_cfg, task, E, autoreset=True, obs_layout="flat",
            device=device)

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
            log_std_init=ppo.log_std_init,
            generator=torch.Generator().manual_seed(seed)).to(device)

    template = network if network is not None \
        else fresh_network(torch.Generator(device).manual_seed(0))

    if ppo.anneal_lr:
        lr_at = linear_schedule(ppo.lr, 0.0, ppo.num_updates
                                * ppo.update_epochs * ppo.num_minibatches)
    else:
        lr_at = lambda count: ppo.lr

    def init(generator: torch.Generator) -> TrainState:
        if generator.device.type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the training on {device}")
        env_state, obs = env_reset()
        net = fresh_network(generator) if network is None \
            else copy.deepcopy(network).to(device)
        return TrainState(
            network=net, opt_state=adam_init(list(net.parameters())),
            env_state=env_state, last_obs=obs,
            generator=generator, update_idx=0)

    def _rollout(net, env_state, obs, noise):
        """`rollout_steps` control steps of the Gaussian policy: one
        forward pass and one env step each, nothing read back."""
        steps = []
        with torch.no_grad():
            for t in range(T):
                mean, log_std, value = net(obs)
                action = mean + torch.exp(log_std) * noise[t]
                log_prob = gaussian_log_prob(mean, log_std, action)
                env_state, next_obs, reward, term, trunc = env_step(
                    env_state, action.reshape(E, n_drones,
                                              act_dim_per_drone))
                done = torch.logical_or(term, trunc).to(obs.dtype)
                steps.append((obs, action, log_prob, value, reward, done))
                obs = next_obs
            last_value = net(obs)[2]
        traj = Transition(*(torch.stack(x) for x in zip(*steps)))
        return env_state, obs, traj, last_value

    def _gae(traj: Transition, last_value):
        # done[t] marks that the state AFTER step t is a reset state, so the
        # bootstrap V(s_{t+1}) and the recursive GAE term are both masked by
        # (1 - done[t]) of the CURRENT transition.
        nonterminal = 1.0 - traj.done
        next_value = torch.cat([traj.value[1:], last_value[None]])
        delta = traj.reward + ppo.gamma * next_value * nonterminal \
            - traj.value
        coef = ppo.gamma * ppo.gae_lambda * nonterminal
        gae = torch.zeros_like(last_value)
        advantages = [None] * T
        for t in reversed(range(T)):
            gae = delta[t] + coef[t] * gae
            advantages[t] = gae
        advantages = torch.stack(advantages)
        return advantages, advantages + traj.value

    def _loss(net, batch: Transition, advantages, returns):
        mean, log_std, value = net(batch.obs)
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)
        norm_adv = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-8)
        pg1 = ratio * norm_adv
        pg2 = torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) \
            * norm_adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_loss = 0.5 * torch.square(value - returns).mean()
        ent = gaussian_entropy(log_std).mean()
        total = pg_loss + ppo.vf_coef * v_loss - ppo.ent_coef * ent
        return total, (pg_loss, v_loss, ent)

    def _draws(generator) -> Draws:
        noise = torch.randn((T, E, act_dim), generator=generator,
                            device=device)
        n = T * E if ppo.sb3_minibatching else T
        perms = torch.stack([
            torch.randperm(n, generator=generator, device=device)
            for _ in range(ppo.update_epochs)])
        return Draws(noise, perms)

    def update(ts: TrainState, draws: Draws | None = None,
               after_rollout=None):
        net = ts.network
        if draws is None:
            draws = _draws(ts.generator)
        # ---- rollout ----
        env_state, last_obs, traj, last_value = _rollout(
            net, ts.env_state, ts.last_obs, draws.noise)
        advantages, returns = _gae(traj, last_value)
        if after_rollout is not None:
            after_rollout()

        # ---- minibatching ----
        if ppo.sb3_minibatching:
            total = T * E
            mb_size = total // ppo.num_minibatches
            flat = Transition(*(x.reshape((total,) + x.shape[2:])
                                for x in traj))
            flat_adv, flat_ret = advantages.reshape(total), \
                returns.reshape(total)
        else:
            mb_size = max(1, T // ppo.num_minibatches)
            # merge (T_mb, E) ENV-MAJOR, as the JAX package does
            merge = lambda x: x.transpose(0, 1).reshape((-1,) + x.shape[2:])

        params = list(net.parameters())
        opt_state = ts.opt_state
        aux = []
        for epoch in range(ppo.update_epochs):
            perm = draws.perms[epoch]
            for i in range(ppo.num_minibatches):
                take = perm[i * mb_size:(i + 1) * mb_size]
                if ppo.sb3_minibatching:
                    mb = Transition(*(x[take] for x in flat))
                    adv, ret = flat_adv[take], flat_ret[take]
                else:
                    mb = Transition(*(merge(x[take]) for x in traj))
                    adv, ret = merge(advantages[take]), merge(returns[take])
                with ieee_fp32_convs():
                    total_loss, terms = _loss(net, mb, adv, ret)
                    grads = torch.autograd.grad(total_loss, params)
                opt_state = clip_adam_step(
                    params, list(grads), opt_state, lr_at(opt_state.count),
                    ppo.max_grad_norm)
                aux.append(torch.stack([x.detach() for x in terms]))
        aux = torch.stack(aux).mean(dim=0)
        metrics = {
            "mean_reward": traj.reward.mean(),
            "mean_value": traj.value.mean(),
            "pg_loss": aux[0],
            "v_loss": aux[1],
            "entropy": aux[2],
        }
        return ts._replace(opt_state=opt_state, env_state=env_state,
                           last_obs=last_obs,
                           update_idx=ts.update_idx + 1), metrics

    def update_many(ts: TrainState, num_updates: int):
        """`num_updates` chained updates; every metric stacked on a leading
        (num_updates,) axis."""
        history = []
        for _ in range(num_updates):
            ts, metrics = update(ts)
            history.append(metrics)
        return ts, {k: torch.stack([m[k] for m in history])
                    for k in history[0]}

    def evaluate(params_or_network, generator=None,
                 num_steps: int | None = None, episodic: bool = False):
        """Deterministic-policy rollout on the training env path; returns
        the summed reward per env, (num_envs,), on the device.

        `params_or_network` is a module or a state_dict for the returned
        `network`.  `generator` is accepted for the JAX signature and
        unused: the policy's mean is deterministic.  episodic=True stops
        each env's sum at its first terminated/truncated signal (SB3's
        EvalCallback).  The reference episode lasts episode_len_sec *
        ctrl_freq + 2 control steps (QUIRKS.md #11), the default
        num_steps.
        """
        if isinstance(params_or_network, torch.nn.Module):
            net = params_or_network
        else:
            net = copy.deepcopy(template)
            net.load_state_dict(params_or_network)
        if num_steps is None:
            num_steps = int(getattr(task, "episode_len_sec", 8.0)
                            * env_cfg.ctrl_freq) + 2
        env_state, obs = env_reset()
        alive = torch.ones(E, dtype=torch.bool, device=device)
        rewards = []
        with torch.no_grad():
            for _ in range(num_steps):
                mean = net(obs)[0]
                env_state, next_obs, reward, term, trunc = env_step(
                    env_state, mean.reshape(E, n_drones,
                                            act_dim_per_drone))
                if episodic:
                    reward = torch.where(alive, reward, 0.0)
                    alive = alive & ~(term | trunc)
                rewards.append(reward)
                obs = next_obs
        return torch.stack(rewards).sum(dim=0)

    update.many = update_many
    update.env_path = env_path
    return init, update, evaluate, template
