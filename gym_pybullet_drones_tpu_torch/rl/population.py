"""Population PPO: K independent policies trained in one trainer.

Counterpart of the JAX package's `rl/population.py`.  There, `jax.vmap`
lifts the single-policy update over a leading member axis; here the
trainer's env, update and evaluation are written over that axis once
(`rl/ppo.py`: `make_env`, `make_update`, `make_evaluate`), and
`make_train` is their case K = 1.  The K members' environments are ONE
env of K x E envs (member k owns env columns [k*E, (k+1)*E)), so a control
step is one env-kernel launch for all K members: the fused kernel
(`make_fused_rollout`) where `fused_spec` admits (cfg, task), else the
batched step.  The K policies are one `PopulationActorCritic`, whose
every layer is one batched product over the members, and Adam acts on the
stacked tensors.  So an update enqueues about the launches of one
single-policy update, for K times the work: on a card whose trainer is
bound by the host's launches, aggregate env-steps/s grow with K.

On RGB observations the K policies are one `PopulationActorCriticCNN`
(each trunk layer one grouped convolution over the members, each dense
layer one batched product), and a control step is the batched step's one
K1 launch and one render launch for all K x E envs, as `make_train` picks
the NatureCNN and the batched step for one policy.

Each member trains as an independent run would: its own noise and
minibatch permutations, its own advantage normalisation and loss, its own
global-norm gradient clip (optax's clip under `jax.vmap`).  The total loss
is the SUM of the members' losses, so each member's gradient is its own.
The optimizer step count, and so the learning-rate schedule, is shared.

Over the ranks of a `parallel.Mesh` the members split with ZERO
collectives (`shard_population`, `make_sharded_population_update`): rank
r trains members [r*K/R, (r+1)*K/R) on its own device, on its columns of
the K x E env, with its members' slices of the global population draw,
so each member trains as it does in one process.
"""
from __future__ import annotations

import torch

from gym_pybullet_drones_tpu_torch.envs import core
from gym_pybullet_drones_tpu_torch.models.cnn import PopulationActorCriticCNN
from gym_pybullet_drones_tpu_torch.models.mlp import PopulationActorCritic
from gym_pybullet_drones_tpu_torch.parallel.mesh import shard_train_state
from gym_pybullet_drones_tpu_torch.rl.ppo import (
    AdamState, Draws, PPOConfig, TrainState, adam_init, chain_updates,
    compute_dtype_of, make_env, make_evaluate, make_train, make_update)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ObservationType


def make_train_population(env_cfg: core.AviaryConfig, task, ppo: PPOConfig,
                          num_policies: int, device=None,
                          env_path: str | None = None):
    """Build (pop_init, pop_update, pop_evaluate, network) for K policies.

    pop_init(generator) -> TrainState: the reset of the K x E envs and a
    `PopulationActorCritic` whose member k is the `ActorCritic` seeded
    from the k-th of K seeds drawn from `generator` in one call (for RGB
    observations a `PopulationActorCriticCNN` of `ActorCriticCNN`s, one
    drone an env, on the batched path: `env_path="fused"` raises, as
    `fused_spec` refuses RGB).  The TrainState's `last_obs` is (K, E,
    obs_dim); its `env_state` is the K x E env's (the fused carry's
    columns, or the flat EnvState's rows, member-major); the Adam moments
    carry the member axis; `generator` draws every member's noise and
    permutations.

    pop_update(ts, draws=None, after_rollout=None) -> (ts, metrics): one
    update of every member (`ppo.make_update`, the update `make_train`
    runs for one member); metrics are (K,) device tensors.  `draws` is a
    `Draws` with a leading member axis, noise (K, rollout_steps, E,
    act_dim) and perms (K, update_epochs, n), member k's being what
    `make_train`'s update takes.  pop_update.many(ts, n) chains n
    updates, metrics (K, n).  pop_update.env_path, .num_policies, and
    .single: `make_train`'s update of one member at E envs on the same env
    path, built at its first call (`member_state` gives it a member's
    TrainState); .sharded(mesh): `make_sharded_population_update`'s.

    pop_evaluate(net, generator=None, num_steps=None, episodic=False) ->
    (K, E): `make_evaluate`'s, every member on its own E envs; `net` is a
    population module or a state_dict for the returned `network` (K
    members, seed 0).
    """
    rgb = getattr(task, "obs", None) == ObservationType.RGB
    if rgb and env_cfg.num_drones != 1:
        raise ValueError("the CNN policy reads one drone's image: RGB "
                         "training takes one drone an env")
    device = resolve_device(device)
    K, T, E = num_policies, ppo.rollout_steps, ppo.num_envs
    act_dim = env_cfg.num_drones * task.action_dim(env_cfg)
    obs_dim = env_cfg.num_drones * task.obs_dim(env_cfg)
    compute_dtype = compute_dtype_of(ppo)
    reset, step, env_path = make_env(env_cfg, task, K, E, device, env_path)

    def fresh_network(generator: torch.Generator) -> torch.nn.Module:
        seeds = torch.randint(0, 2 ** 62, (K,), generator=generator,
                              device=generator.device).tolist()
        generators = [torch.Generator().manual_seed(s) for s in seeds]
        if rgb:
            return PopulationActorCriticCNN(
                K, act_dim, generators=generators).to(device)
        return PopulationActorCritic(
            K, obs_dim, act_dim, hidden=tuple(ppo.hidden),
            log_std_init=ppo.log_std_init, compute_dtype=compute_dtype,
            generators=generators).to(device)

    template = fresh_network(torch.Generator(device).manual_seed(0))
    n_perm = T * E if ppo.sb3_minibatching else T

    def pop_init(generator: torch.Generator) -> TrainState:
        if generator.device.type != device.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the training on {device}")
        env_state, obs = reset()
        net = fresh_network(generator)
        return TrainState(
            network=net, opt_state=adam_init(list(net.parameters())),
            env_state=env_state, last_obs=obs, generator=generator,
            update_idx=0, reset_noise=step.reset_noise())

    def draws_of(generator) -> Draws:
        noise = torch.randn((K, T, E, act_dim), generator=generator,
                            device=device)
        # K x epochs uniform permutations in one call: the order of
        # independent float64 uniforms
        perms = torch.rand((K, ppo.update_epochs, n_perm),
                           generator=generator, device=device,
                           dtype=torch.float64).argsort(dim=-1)
        return Draws(noise, perms)

    def members_update(k: int, step, members: slice):
        """The update of `k` members on `step`, taking `members` of the
        population's draws."""
        run = make_update(ppo, step, k, lambda x: x)

        def update(ts: TrainState, draws: Draws | None = None,
                   after_rollout=None):
            if draws is None:
                draws = draws_of(ts.generator)
            if ts.reset_noise is not None:
                step.use_reset_noise(ts.reset_noise)
            (opt_state, env_state, obs), metrics = run(
                ts.network, ts.opt_state, ts.env_state, ts.last_obs,
                Draws(draws.noise[members], draws.perms[members]),
                after_rollout)
            return ts._replace(opt_state=opt_state, env_state=env_state,
                               last_obs=obs,
                               update_idx=ts.update_idx + 1), metrics
        update.many = chain_updates(update)
        update.env_path = env_path
        update.num_policies = K
        return update

    pop_update = members_update(K, step, slice(None))

    def sharded(mesh):
        # this rank's members, on its columns of the K x E env
        check_members(K, mesh)
        k = K // mesh.size
        _, local_step, _ = make_env(env_cfg, task, k, E, mesh.device,
                                    env_path, mesh)
        update = members_update(
            k, local_step, slice(mesh.rank * k, (mesh.rank + 1) * k))
        update.mesh = mesh
        return update

    pop_update.sharded = sharded
    built = []

    def single(ts: TrainState, draws: Draws | None = None,
               after_rollout=None):
        # built at its first call: its env's construction renders an RGB
        # task's reset image, a launch no population update needs
        if not built:
            built.append(make_train(env_cfg, task, ppo, device=device,
                                    env_path=env_path)[1])
        return built[0](ts, draws, after_rollout)

    pop_update.single = single
    pop_evaluate = make_evaluate(env_cfg, task, template, reset, step)
    return pop_init, pop_update, pop_evaluate, template


def check_members(num_policies: int, mesh) -> None:
    if num_policies % mesh.size:
        raise ValueError(
            f"num_policies={num_policies} must divide the mesh "
            f"size {mesh.size}")


def shard_population(ts: TrainState, mesh) -> TrainState:
    """This rank's members of a population TrainState (from `pop_init`,
    K = `ts.network.num_members` divisible by the mesh's size): their
    network, Adam moments, env columns, observations and rows of the
    reset-noise stream, on the mesh's device; the generator replicated."""
    net = ts.network
    check_members(net.num_members, mesh)
    lo, hi = mesh.env_range(net.num_members)
    local = shard_train_state(ts, mesh)
    pick = lambda moments: [m[lo:hi].clone() for m in moments]
    return local._replace(
        network=type(net).from_members(
            [net.member(k) for k in range(lo, hi)]).to(mesh.device),
        opt_state=AdamState(ts.opt_state.count, pick(local.opt_state.mu),
                            pick(local.opt_state.nu)))


def make_sharded_population_update(pop_update, mesh):
    """The population update of this rank's members (`shard_population`'s
    TrainState): K / R members on its columns of the K x E env, each on
    its slice of the global population draw.  No collective: the members
    never exchange anything.  K must divide evenly over the ranks."""
    return pop_update.sharded(mesh)


def member_state(ts: TrainState, k: int) -> TrainState:
    """Member k of a population TrainState as a single run's TrainState
    (what `pop_update.single` takes): copies of its network, Adam moments,
    env columns and observations; the generator is the population's.  The
    population's reset-noise stream is not sliced: the member's env draws
    from the stream of the env it is stepped in."""
    net = ts.network
    K = net.num_members
    one = net.member(k)
    pick = lambda moments: [m[k].reshape(p.shape).clone() for m, p in
                            zip(moments, one.parameters())]
    opt = AdamState(ts.opt_state.count, pick(ts.opt_state.mu),
                    pick(ts.opt_state.nu))
    if isinstance(ts.env_state, torch.Tensor):     # the fused carry (RC, B)
        env_state = ts.env_state.chunk(K, dim=1)[k].contiguous()
    else:                                          # flat leaves, env-major
        env_state = core.map_leaves(lambda x: x.chunk(K)[k].clone(),
                                    ts.env_state)
    return TrainState(one, opt, env_state, ts.last_obs[k].clone(),
                      ts.generator, ts.update_idx)
