"""The port's PPO (gym_pybullet_drones_tpu_torch/rl/ppo.py) against the JAX
package's `rl/ppo.py`, on the CPU.

One JAX trainer per module (a module-scoped fixture): Hover, DYN, RPM,
`episode_len_sec=0.5` (every env truncates on control step 16 and
auto-resets inside the 24-step rollout, so GAE's done mask acts), 8 envs x
24 steps, 2 minibatches, 2 epochs, on the JAX batched step (the CPU has no
fused kernel).  `jax.random` cannot be reproduced in torch, so the test
replays the JAX update's key schedule (`ppo.py:187`, `:203`, `:196`,
`:274-278`) with `jax.random` and hands the same noise and permutations to
the port's `update(ts, draws)`, starting from the same params.

Under the suite's x64 the flax `log_std` leaf is float64; the JAX
TrainState is cast to float32 as test input, as it is in real runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_pybullet_drones_tpu.rl import ppo as jppo

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

from tests._torch_helpers import pair

E, T, MB, EPOCHS = 8, 24, 2, 2
EPISODE_S = 0.5
# After one update (4 Adam steps of lr 3e-4 from the same params) on the
# same draws.  Adam's first steps move each weight by about lr x g / |g|,
# so a gradient that differs by a relative d moves a weight by about
# lr x d; the weights move by about 1e-3 in all.  Measured on this
# configuration: 6e-8 on the weights, 2.4e-6 on the obs after the rollout,
# at most 4e-6 on v_loss (21.3) and 2e-7 on pg_loss, on both env paths.
PARAM_ATOL = 1e-6
OBS_ATOL = 2e-5            # tests/test_fused.py's state and obs tolerance
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
# the optimizer alone, three steps on fixed float32 gradients; the params
# are N(0, 1), where an ulp is up to 4.8e-7 (measured: 1.2e-7)
OPT_TOL = dict(rtol=0, atol=5e-7)
# evaluate: sums of 16 rewards of about 1.5 (measured: equal)
EVAL_TOL = dict(rtol=0, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are small: one intra-op thread runs them faster than
    a pool of threads that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if getattr(x, "dtype", None) == jnp.float64 else x, tree)


def _jax_draws(key, n_perm):
    """The rollout noise and the epoch permutations one JAX update draws
    from `key`, in its own order."""
    noise, perms = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (E, 4), jnp.float32)))
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, n_perm)))
    return tppo.Draws(torch.from_numpy(np.stack(noise)),
                      torch.from_numpy(np.stack(perms)).long())


def _state_dict(params):
    return convert.actor_critic_state_dict_from_flax(
        jax.tree.map(np.asarray, params))


def _configs(**kw):
    base = dict(num_envs=E, rollout_steps=T, num_minibatches=MB,
                update_epochs=EPOCHS)
    base.update(kw)
    return jppo.PPOConfig(**base), tppo.PPOConfig(**base)


def _cfg_pair():
    (jcfg, jtask), (tcfg, ttask) = pair("hover", "rpm")
    return ((jcfg, dataclasses.replace(jtask, episode_len_sec=EPISODE_S)),
            (tcfg, dataclasses.replace(ttask, episode_len_sec=EPISODE_S)))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX trainer, its float32 initial TrainState, and a maker of
    the jitted update for a PPOConfig variant (each variant compiles only
    its update; the env reset and the init are shared)."""
    (jcfg, jtask), _ = _cfg_pair()
    jp, _ = _configs()
    init, update, evaluate, network = jppo.make_train(
        jcfg, jtask, jp, env_path="batched")
    ts0 = _f32(jax.jit(init)(jax.random.key(0)))
    updates = {}

    def jax_update(**kw):
        key = tuple(sorted(kw.items()))
        if key not in updates:
            ppo, _ = _configs(**kw)
            _, upd, _, _ = jppo.make_train(jcfg, jtask, ppo,
                                           env_path="batched")
            if ppo.anneal_lr:
                steps = ppo.num_updates * ppo.update_epochs \
                    * ppo.num_minibatches
                lr = optax.linear_schedule(ppo.lr, 0.0, steps)
            else:
                lr = ppo.lr
            tx = optax.chain(optax.clip_by_global_norm(ppo.max_grad_norm),
                             optax.adam(lr, eps=1e-5))
            updates[key] = (jax.jit(upd), _f32(tx.init(ts0.params)))
        return updates[key]

    return ts0, jax_update, evaluate


CASES = [("batched", {}), ("fused", {}),
         ("batched", {"sb3_minibatching": True}),
         # num_updates 1: the learning rate falls to 0 over the 4 steps
         ("fused", {"anneal_lr": True, "total_timesteps": E * T})]
IDS = ["batched", "fused", "batched-sb3", "fused-anneal"]


@pytest.mark.parametrize("path,kw", CASES, ids=IDS)
def test_one_update_matches_jax(jax_side, path, kw):
    ts0, jax_update, _ = jax_side
    jupd, opt_state = jax_update(**kw)
    jts, jm = jupd(ts0._replace(opt_state=opt_state))
    _, tp = _configs(**kw)
    _, (tcfg, ttask) = _cfg_pair()
    init, update, _, _ = tppo.make_train(tcfg, ttask, tp, device="cpu",
                                         env_path=path)
    assert update.env_path == path
    ts = init(torch.Generator().manual_seed(0))
    start = _state_dict(ts0.params)
    ts.network.load_state_dict(start)
    draws = _jax_draws(ts0.key, T * E if tp.sb3_minibatching else T)
    ts, tm = update(ts, draws)
    assert ts.update_idx == 1 and ts.opt_state.count == EPOCHS * MB
    # the rollout crossed a truncation and an auto-reset in every env
    np.testing.assert_allclose(ts.last_obs.numpy(), np.asarray(jts.last_obs),
                               rtol=0, atol=OBS_ATOL)
    for k in ("mean_reward", "mean_value", "pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   err_msg=k, **METRIC_TOL)
    want = _state_dict(jts.params)
    got = ts.network.state_dict()
    moved = 0.0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        moved = max(moved, float((v - start[k]).abs().max()))
    assert moved > 100 * PARAM_ATOL      # the update did move them


# compute_dtype="bfloat16" on the same weights and draws.  On the CPU the
# bf16 forward passes of both packages agree bit for bit, so the rollout
# (last obs, mean reward and value) keeps the float32 tolerances above
# (measured: 1.5e-6 on the obs, 2e-9 on mean_value, where a float32
# policy is 6e-5 off).  The backward passes round their bf16 products in
# another order, and Adam turns the bf16 rounding of a gradient entry near
# zero into a step of up to lr: measured 2.9e-4 at most on the weights,
# which move by 1.2e-3, with at most 2.7% of a tensor's entries off by
# more than 2e-5, and 2.3e-4 relative on the loss metrics, within bf16's
# 2^-8.
BF16_PARAM_ATOL = 5e-4
BF16_PARAM_NEAR, BF16_FAR_SHARE = 2e-5, 0.05
BF16_LOSS_TOL = dict(rtol=2.0 ** -8, atol=1e-6)


@pytest.mark.parametrize("path", ["batched", "fused"])
def test_bf16_update_matches_jax(jax_side, path):
    ts0, jax_update, _ = jax_side
    jupd, opt_state = jax_update(compute_dtype="bfloat16")
    jts, jm = jupd(ts0._replace(opt_state=opt_state))
    _, tp = _configs(compute_dtype="bfloat16")
    _, (tcfg, ttask) = _cfg_pair()
    init, update, _, _ = tppo.make_train(tcfg, ttask, tp, device="cpu",
                                         env_path=path)
    ts = init(torch.Generator().manual_seed(0))
    assert ts.network.compute_dtype == torch.bfloat16
    ts.network.load_state_dict(_state_dict(ts0.params))
    ts, tm = update(ts, _jax_draws(ts0.key, T))
    np.testing.assert_allclose(ts.last_obs.numpy(), np.asarray(jts.last_obs),
                               rtol=0, atol=OBS_ATOL)
    for k in ("mean_reward", "mean_value"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **METRIC_TOL)
    for k in ("pg_loss", "v_loss", "entropy"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **BF16_LOSS_TOL)
    got = ts.network.state_dict()
    for k, v in _state_dict(jts.params).items():
        off = (got[k] - v).abs()
        assert float(off.max()) <= BF16_PARAM_ATOL, (k, float(off.max()))
        assert float((off > BF16_PARAM_NEAR).float().mean()) \
            <= BF16_FAR_SHARE, k


def test_linear_schedule_matches_optax():
    ours = tppo.linear_schedule(3e-4, 0.0, 40)
    theirs = optax.linear_schedule(3e-4, 0.0, 40)
    for k in range(43):
        assert abs(ours(k) - float(theirs(k))) <= 1e-12, k


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["clipped", "unclipped"])
def test_optimizer_step_matches_optax(scale):
    rng = np.random.default_rng(2)
    shapes = [(64, 72), (64,), (4, 64), (4,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.normal(size=s) / np.sqrt(s[0]))
              .astype(np.float32) for s in shapes] for _ in range(3)]
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads[0]))
    assert (norm > 0.5) == (scale > 1)
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(1e-3, eps=1e-5))
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    jstep = jax.jit(lambda g, st, p: (lambda u, st: (
        optax.apply_updates(p, u), st))(*tx.update(g, st, p)))
    # one policy: a member axis of 1 on every tensor
    tparams = [torch.from_numpy(p.copy())[None] for p in params]
    tstate = tppo.adam_init(tparams)
    for g in grads:
        jparams, jstate = jstep([jnp.asarray(x) for x in g], jstate,
                                jparams)
        tstate = tppo.clip_adam_step(
            tparams, [torch.from_numpy(x)[None] for x in g], tstate, 1e-3,
            0.5)
        for tpar, jpar in zip(tparams, jparams):
            np.testing.assert_allclose(tpar[0].numpy(), np.asarray(jpar),
                                       **OPT_TOL)
    assert tstate.count == 3


def test_evaluate_episodic_matches_jax(jax_side):
    ts0, _, jevaluate = jax_side
    jret = np.asarray(jax.jit(lambda p: jevaluate(
        p, jax.random.key(1), num_steps=30, episodic=True))(ts0.params))
    _, tp = _configs()
    _, (tcfg, ttask) = _cfg_pair()
    _, _, evaluate, network = tppo.make_train(tcfg, ttask, tp, device="cpu")
    sd = _state_dict(ts0.params)
    tret = evaluate(sd, None, num_steps=30, episodic=True)
    assert tret.shape == (E,)
    np.testing.assert_allclose(tret.numpy(), jret, **EVAL_TOL)
    # episodic: the sum stops at the truncation on step 16
    full = evaluate(sd, None, num_steps=30)
    assert (full > tret).all()


def test_env_path_choice():
    _, (tcfg, ttask) = _cfg_pair()
    _, tp = _configs()
    assert tppo.make_train(tcfg, ttask, tp, device="cpu")[1].env_path \
        == "fused"
    with pytest.raises(ValueError):
        tppo.make_train(tcfg, ttask, tp, device="cpu", env_path="other")
    # compute_dtype builds the MLP in that dtype, over float32 weights
    net = tppo.make_train(tcfg, ttask, dataclasses.replace(
        tp, compute_dtype="bfloat16"), device="cpu")[3]
    assert net.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with pytest.raises(ValueError):
        tppo.make_train(tcfg, ttask, dataclasses.replace(
            tp, compute_dtype="int32"), device="cpu")


def test_update_many_and_learning_smoke():
    """A seeded CPU run learns, in the spirit of
    tests/test_ppo.py::test_ppo_seeded_reward_floor but sized to seconds:
    ONE_D_RPM Hover (the learning target's action type) on DYN physics,
    1 s episodes, 16 envs x 32 steps, 4 minibatches, 10 epochs, lr 1e-3, 8
    updates.  The deterministic policy's episodic return must beat the
    untrained one's by 1.0 (its own baseline: the untrained mean action
    hovers in place at 1.37 a step), and the last two updates' mean reward
    the first update's.  One seed: a fixed generator on the CPU is
    deterministic."""
    _, (tcfg, ttask) = _cfg_pair()
    ttask = dataclasses.replace(ttask, act=type(ttask.act).ONE_D_RPM,
                                episode_len_sec=1.0)
    tp = tppo.PPOConfig(num_envs=16, rollout_steps=32, num_minibatches=4,
                        update_epochs=10, lr=1e-3)
    init, update, evaluate, _ = tppo.make_train(tcfg, ttask, tp,
                                                device="cpu")
    ts = init(torch.Generator().manual_seed(1))
    before = float(evaluate(ts.network, episodic=True).mean())
    ts, m = update.many(ts, 8)
    after = float(evaluate(ts.network, episodic=True).mean())
    rewards = m["mean_reward"].numpy()
    assert rewards.shape == (8,) and ts.update_idx == 8
    assert np.isfinite(rewards).all() and np.isfinite(after)
    assert after - before > 1.0, (before, after)
    assert rewards[-2:].mean() > rewards[0], rewards
