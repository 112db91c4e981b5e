"""The port's population trainer (gym_pybullet_drones_tpu_torch/rl/
population.py) against the port's single-policy trainer and against the
JAX package's `make_train_population`, on the CPU.

K = 2 members, Hover, DYN, RPM, `episode_len_sec=0.125` (every env
truncates on control step 4 and auto-resets inside the 8-step rollout;
a length that is exact in binary, so both packages truncate on the same
step), 8 envs a member x 8 steps, 2 minibatches, 2 epochs.  Member k of
a population
update must be what `make_train`'s update makes of member k's weights and
draws (the batched products round as the single ones do but for their
order: `PARAM_ATOL`), and the population what the JAX package's vmapped
update makes of the same params on its own key schedule, replayed here
with `jax.random` (`pop_init` splits the seed key K ways; each member
then draws as `tests/test_torch_ppo.py` replays).  One JAX population
update is compiled, in a module-scoped fixture, on the JAX batched step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_pybullet_drones_tpu.models import mlp as jmlp
from gym_pybullet_drones_tpu.rl import PPOConfig as JPPOConfig
from gym_pybullet_drones_tpu.rl import make_train_population as j_population

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.models import (
    ActorCritic, PopulationActorCritic)
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_fused
from gym_pybullet_drones_tpu_torch.rl import population as tpop
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

from tests._torch_helpers import pair
from tests.test_torch_ppo import METRIC_TOL, OBS_ATOL, OPT_TOL, PARAM_ATOL

K, E, T, MB, EPOCHS = 2, 8, 8, 2, 2
EPISODE_S = 0.125
METRICS = ("mean_reward", "mean_value", "pg_loss", "v_loss", "entropy")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg_pair():
    (jcfg, jtask), (tcfg, ttask) = pair("hover", "rpm")
    return ((jcfg, dataclasses.replace(jtask, episode_len_sec=EPISODE_S)),
            (tcfg, dataclasses.replace(ttask, episode_len_sec=EPISODE_S)))


def _ppo(**kw):
    return tppo.PPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                          update_epochs=EPOCHS, **kw)


def _draws(seed, n_perm):
    rng = np.random.default_rng(seed)
    return tppo.Draws(
        torch.from_numpy(rng.normal(size=(K, T, E, 4)).astype(np.float32)),
        torch.from_numpy(np.stack([[rng.permutation(n_perm)
                                    for _ in range(EPOCHS)]
                                   for _ in range(K)])))


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if getattr(x, "dtype", None) == jnp.float64 else x, tree)


def _jax_member_draws(key):
    """What one member's JAX update draws from its key (the order of
    tests/test_torch_ppo.py's replay)."""
    noise, perms = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (E, 4), jnp.float32)))
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, T)))
    return np.stack(noise), np.stack(perms)


@pytest.fixture(scope="module")
def jax_population():
    """One JAX population update from `pop_init(key(0))`, float32 as in
    real runs: (initial TrainState, TrainState after, metrics)."""
    (jcfg, jtask), _ = _cfg_pair()
    jp = JPPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                    update_epochs=EPOCHS)
    pinit, pupd, _, _ = j_population(jcfg, jtask, jp, K, env_path="batched")
    ts0 = _f32(jax.jit(pinit)(jax.random.key(0)))
    ts1, m = jax.jit(pupd)(ts0)
    return ts0, ts1, m


def _population(path, **kw):
    _, (tcfg, ttask) = _cfg_pair()
    return tpop.make_train_population(tcfg, ttask, _ppo(**kw), K,
                                      device="cpu", env_path=path)


CASES = [("batched", {}), ("fused", {}),
         ("batched", {"sb3_minibatching": True}),
         ("fused", {"anneal_lr": True, "total_timesteps": E * T})]
IDS = ["batched", "fused", "batched-sb3", "fused-anneal"]


def _hold_members(path, seed=3, **kw):
    """One population update against `make_train`'s update of each member
    (its weights, Adam state, envs and draws)."""
    pinit, pupd, _, _ = _population(path, **kw)
    assert pupd.env_path == path and pupd.num_policies == K
    ts = pinit(torch.Generator().manual_seed(seed))
    singles = [tpop.member_state(ts, k) for k in range(K)]
    draws = _draws(4, T * E if kw.get("sb3_minibatching") else T)
    ts, m = pupd(ts, draws)
    assert ts.update_idx == 1 and ts.opt_state.count == EPOCHS * MB
    for k in range(K):
        one, m1 = pupd.single(singles[k], tppo.Draws(draws.noise[k],
                                                     draws.perms[k]))
        mine = ts.network.member(k).state_dict()
        for name, v in one.network.state_dict().items():
            np.testing.assert_allclose(mine[name].numpy(), v.numpy(),
                                       rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"member {k} {name}")
        for q in METRICS:
            np.testing.assert_allclose(float(m[q][k]), float(m1[q]),
                                       err_msg=f"member {k} {q}",
                                       **METRIC_TOL)
        np.testing.assert_array_equal(ts.last_obs[k].numpy(),
                                      one.last_obs.numpy())
        # the Adam moments, to 1e-4 of each tensor's largest entry
        got = tpop.member_state(ts, k)
        for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                        one.opt_state.mu + one.opt_state.nu):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("path,kw", CASES, ids=IDS)
def test_members_match_single_updates(path, kw):
    _hold_members(path, **kw)


@pytest.mark.parametrize("limit", [3.6, 1e9], ids=["straddle", "unclipped"])
def test_loss_and_clip_are_per_member(limit, monkeypatch):
    """Each member's gradient is its own.  At max_grad_norm 3.6 the
    members' gradient norms (about 2.8-4.2 here) straddle the limit on
    some optimizer step, so a clip by the population's norm would scale a
    member that must be left alone.  Unclipped, a loss averaged over the
    members would halve every gradient, which Adam's eps (1e-5 outside
    the root) turns into other steps.  Both would break the parity."""
    norms, real = [], tppo.clip_adam_step

    def spy(params, grads, *rest):
        norms.append(torch.linalg.vector_norm(torch.cat(
            [g.flatten(1) for g in grads], dim=1), dim=1).tolist())
        return real(params, grads, *rest)
    monkeypatch.setattr(tppo, "clip_adam_step", spy)
    _hold_members("batched", seed=0, max_grad_norm=limit)
    above = [[n > limit for n in step] for step in norms if len(step) == K]
    if limit < 1e3:
        assert [True, False] in above or [False, True] in above, norms
    else:
        assert not any(map(any, above)), norms


def test_population_matches_jax(jax_population):
    ts0, jts, jm = jax_population
    pinit, pupd, _, _ = _population("batched")
    ts = pinit(torch.Generator().manual_seed(0))
    start = convert.population_state_dict_from_flax(
        jax.tree.map(np.asarray, ts0.params))
    ts.network.load_state_dict(start)
    replay = [_jax_member_draws(ts0.key[k]) for k in range(K)]
    draws = tppo.Draws(*(torch.from_numpy(np.stack(x)).to(dt) for x, dt in
                         zip(zip(*replay), (torch.float32, torch.long))))
    ts, tm = pupd(ts, draws)
    np.testing.assert_allclose(ts.last_obs.numpy(),
                               np.asarray(jts.last_obs), rtol=0,
                               atol=OBS_ATOL)
    for q in METRICS:
        assert tm[q].shape == (K,)
        np.testing.assert_allclose(tm[q].numpy(), np.asarray(jm[q]),
                                   err_msg=q, **METRIC_TOL)
    want = convert.population_state_dict_from_flax(
        jax.tree.map(np.asarray, jts.params))
    got = ts.network.state_dict()
    moved = 0.0
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        moved = max(moved, float((v - start[name]).abs().max()))
    assert moved > 100 * PARAM_ATOL


@pytest.mark.parametrize("scales", [(10.0, 0.01), (0.01, 10.0)],
                         ids=["clipped-unclipped", "unclipped-clipped"])
def test_clip_is_per_member(scales):
    """clip_adam_step over a member axis against optax's chain under
    jax.vmap, with one member's gradient norm above max_grad_norm and the
    other's below: a clip by the population's norm would shrink the small
    one too."""
    rng = np.random.default_rng(5)
    shapes = [(64, 72), (64,), (4, 64), (4,)]
    params = [rng.normal(size=(K,) + s).astype(np.float32) for s in shapes]
    grads = [[np.stack([(c * rng.normal(size=s) / np.sqrt(s[0]))
                        for c in scales]).astype(np.float32)
              for s in shapes] for _ in range(3)]
    norms = [np.sqrt(sum(float((g[k].astype(np.float64) ** 2).sum())
                         for g in grads[0])) for k in range(K)]
    assert [n > 0.5 for n in norms] == [c > 1 for c in scales]
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(1e-3, eps=1e-5))
    jparams = [jnp.asarray(p) for p in params]
    jstate = jax.vmap(tx.init)(jparams)
    jstep = jax.jit(jax.vmap(lambda g, st, p: (lambda u, st: (
        optax.apply_updates(p, u), st))(*tx.update(g, st, p))))
    tparams = [torch.from_numpy(p.copy()) for p in params]
    tstate = tppo.adam_init(tparams)
    for g in grads:
        jparams, jstate = jstep([jnp.asarray(x) for x in g], jstate, jparams)
        tstate = tppo.clip_adam_step(
            tparams, [torch.from_numpy(x) for x in g], tstate, 1e-3, 0.5)
        for tpar, jpar in zip(tparams, jparams):
            np.testing.assert_allclose(tpar.numpy(), np.asarray(jpar),
                                       **OPT_TOL)


@pytest.mark.parametrize("path", ["batched", "fused"])
def test_evaluate_many_and_one_env_step(path, monkeypatch):
    """pop_evaluate is (K, E) and each row the single evaluate of that
    member; .many stacks (K, n); every control step is ONE env step of the
    K x E envs."""
    calls = []
    mod, name = (kernel_fused, "fused_env_step") if path == "fused" \
        else (kernel_dyn, "dyn_ctrl_step")
    real = getattr(mod, name)

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(mod, name, counted)
    pinit, pupd, pevaluate, network = _population(path)
    ts = pinit(torch.Generator().manual_seed(1))
    ts, m = pupd.many(ts, 2)
    assert {k: tuple(v.shape) for k, v in m.items()} \
        == {k: (K, 2) for k in METRICS}
    assert len(calls) == 2 * T and ts.update_idx == 2
    calls.clear()
    got = pevaluate(ts.network.state_dict(), None, num_steps=9,
                    episodic=True)
    assert got.shape == (K, E) and len(calls) == 9
    assert isinstance(network, PopulationActorCritic)
    _, (tcfg, ttask) = _cfg_pair()
    for k in range(K):
        _, _, evaluate, _ = tppo.make_train(tcfg, ttask, _ppo(),
                                            device="cpu", env_path=path)
        want = evaluate(ts.network.member(k), num_steps=9, episodic=True)
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


def test_population_state_dict_round_trips(jax_population):
    """The JAX population's params (a member axis on every leaf) ->
    PopulationActorCritic: its members are the members' own conversions,
    its forward pass is the vmapped flax forward, and from_members stacks
    them back."""
    params = jax.tree.map(np.asarray, jax_population[0].params)
    sd = convert.population_state_dict_from_flax(params)
    assert sd["pi.0.weight"].shape == (K, 64, 72)
    assert sd["pi.0.bias"].shape == (K, 1, 64)
    net = PopulationActorCritic(K, 72, 4)
    net.load_state_dict(sd)
    obs = np.random.default_rng(8).normal(size=(K, 16, 72)) \
        .astype(np.float32)
    jnet = jmlp.ActorCritic(action_dim=4)
    jout = jax.jit(jax.vmap(jnet.apply))(params, obs)
    with torch.no_grad():
        tout = net(torch.from_numpy(obs))
    for t, j in zip(tout, jout):
        j = np.asarray(j)
        np.testing.assert_allclose(t.detach().numpy().reshape(j.shape), j,
                                   rtol=1e-5, atol=1e-6)
    members = []
    for k in range(K):
        one = convert.actor_critic_state_dict_from_flax(
            jax.tree.map(lambda x: x[k], params))
        for name, v in net.member(k).state_dict().items():
            assert torch.equal(v, one[name]), (k, name)
        members.append(net.member(k))
    again = PopulationActorCritic.from_members(members).state_dict()
    for name, v in sd.items():
        assert torch.equal(again[name], v), name
    with pytest.raises(ValueError):
        convert.population_state_dict_from_flax(
            jax.tree.map(lambda x: x[0], params))


def test_members_init_as_actor_critic():
    """Member k's orthogonal init is the ActorCritic's of the same
    generator seed; the population trainer seeds each member apart."""
    net = PopulationActorCritic(
        3, 72, 4, (16, 16), -1.0,
        generators=[torch.Generator().manual_seed(s) for s in (5, 6, 5)])
    for k, s in enumerate((5, 6, 5)):
        want = ActorCritic(72, 4, (16, 16), -1.0,
                           generator=torch.Generator().manual_seed(s))
        for name, v in net.member(k).state_dict().items():
            assert torch.equal(v, want.state_dict()[name]), (k, name)
    pinit, _, _, _ = _population("fused")
    w = pinit(torch.Generator().manual_seed(0)).network.pi[0].weight
    assert not torch.equal(w[0], w[1])

