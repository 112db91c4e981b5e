"""A population of pixel policies (gym_pybullet_drones_tpu_torch/rl/
population.py on RGB observations, `models.PopulationActorCriticCNN`)
against the port's single-policy pixel trainer and against the JAX
package's `make_train_population`, on the CPU.

K = 2 members, Hover, DYN, ONE_D_RPM, RGB (one drone's 48x64x4 camera
image), `episode_len_sec=0.125` (every env truncates on control step 5
and auto-resets inside the rollout), 4 envs a member x 4 steps, 2
minibatches, 1 epoch: tests/test_torch_rgb_slice.py's update for each
member.  The stacked NatureCNN's forward pass against each member's own
network and against the vmapped flax module; one population update
against the JAX package's (its own key schedule, replayed here with
`jax.random` per member from `ts0.key[k]`), compiled once in a module
fixture on the JAX batched step; each member against `make_train`'s update
of its weights and draws; the refusals; a checkpoint resumed bit for bit.
Images are held by `assert_obs_close`; weights to `PARAM_ATOL`, metrics to
`METRIC_TOL` (the grouped and the single convolutions, the port's and
XLA's, sum in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.models import cnn as jcnn
from gym_pybullet_drones_tpu.rl import PPOConfig as JPPOConfig
from gym_pybullet_drones_tpu.rl import make_train_population as j_population

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs.core import leaves
from gym_pybullet_drones_tpu_torch.models import (
    ActorCriticCNN, PopulationActorCriticCNN)
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_render
from gym_pybullet_drones_tpu_torch.rl import population as tpop
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo
from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)

from tests._torch_helpers import assert_obs_close, pair
from tests.test_torch_rgb_slice import EPISODE_S, IMG, METRIC_TOL, PARAM_ATOL

K, E, T, MB, EPOCHS = 2, 4, 4, 2, 1
METRICS = ("mean_reward", "mean_value", "pg_loss", "v_loss", "entropy")
# the forward pass of the stacked network against the vmapped flax module
# and against each member's own network: float32 sums over 2.7 M
# multiply-adds an image in other orders
FORWARD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rgb_pair(kind="hover"):
    (jcfg, jtask), (tcfg, ttask) = pair(kind, "one_d_rpm")
    rgb = lambda task: dataclasses.replace(
        task, obs=type(task.obs).RGB, episode_len_sec=EPISODE_S)
    return (jcfg, rgb(jtask)), (tcfg, rgb(ttask))


def _ppo():
    return tppo.PPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                          update_epochs=EPOCHS)


def _population(kind="hover", env_path=None):
    _, (tcfg, ttask) = _rgb_pair(kind)
    return tpop.make_train_population(tcfg, ttask, _ppo(), K, device="cpu",
                                      env_path=env_path)


def _images(m, seed):
    return np.random.default_rng(seed).uniform(
        0, 255, size=(K, m, IMG)).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or FORWARD_TOL))


@pytest.mark.parametrize("layout", ["flat", "image"])
def test_forward_matches_members(layout):
    """Member k of the stack is the ActorCriticCNN of generators[k] (a seed
    given twice gives the same member twice), its outputs on obs[k] that
    network's, on flat rows and on (K, M, 48, 64, 4) images; from_members
    and member(k) invert each other."""
    seeds = (5, 6, 5)
    net = PopulationActorCriticCNN(
        3, 4, generators=[torch.Generator().manual_seed(s) for s in seeds])
    members = [ActorCriticCNN(4, generator=torch.Generator().manual_seed(s))
               for s in seeds]
    obs = np.random.default_rng(1).uniform(
        0, 255, size=(3, 5, IMG)).astype(np.float32)
    x = torch.from_numpy(obs if layout == "flat"
                         else obs.reshape(3, 5, 48, 64, 4))
    with torch.no_grad():
        mean, log_std, value = net(x)
        assert mean.shape == (3, 5, 4) and log_std.shape == (3, 1, 4)
        assert value.shape == (3, 5)
        for k, one in enumerate(members):
            for name, v in net.member(k).state_dict().items():
                assert torch.equal(v, one.state_dict()[name]), (k, name)
            m1, l1, v1 = one(x[k])
            _close(mean[k], m1)
            _close(value[k], v1)
            assert torch.equal(log_std[k, 0], l1)
    again = PopulationActorCriticCNN.from_members(members).state_dict()
    for name, v in net.state_dict().items():
        assert torch.equal(again[name], v), name
    assert not torch.equal(net.convs[0].weight[0], net.convs[0].weight[1])


def test_forward_matches_vmapped_flax():
    """The JAX package's vmapped `ActorCriticCNN.apply` (K = 2 members
    initialised under jax.vmap, M = 3 seeded images each) against the port
    loaded through `population_cnn_state_dict_from_flax`: mean and value
    within 1e-5 relative / 1e-6 absolute.  A flatten of the last feature
    map in any other order than each member's (h, w, c) leaves them far
    apart (tests/test_torch_cnn.py)."""
    obs = _images(3, 2)
    jnet = jcnn.ActorCriticCNN(action_dim=4)
    params = jax.jit(jax.vmap(jnet.init, in_axes=(0, None)))(
        jax.random.split(jax.random.key(7), K), jnp.asarray(obs[0, :1]))
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    jm, jl, jv = (np.asarray(v) for v in
                  jax.jit(jax.vmap(jnet.apply))(params, obs))
    sd = convert.population_cnn_state_dict_from_flax(params)
    assert sd["convs.0.weight"].shape == (K, 32, 4, 8, 8)
    assert sd["convs.0.bias"].shape == (K, 32)
    assert sd["dense.weight"].shape == (K, 512, 512)
    assert sd["dense.bias"].shape == (K, 1, 512)
    net = PopulationActorCriticCNN(K, 4)
    net.load_state_dict(sd)
    with torch.no_grad():
        tm, tl, tv = net(torch.from_numpy(obs))
    _close(tm, jm)
    _close(tv, jv)
    np.testing.assert_array_equal(tl[:, 0].detach().numpy(), jl)
    for k in range(K):
        one = convert.actor_critic_cnn_state_dict_from_flax(
            jax.tree.map(lambda x: x[k], params))
        for name, v in net.member(k).state_dict().items():
            assert torch.equal(v, one[name]), (k, name)
    with pytest.raises(ValueError):
        convert.population_cnn_state_dict_from_flax(
            jax.tree.map(lambda x: x[0], params))


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if getattr(x, "dtype", None) == jnp.float64 else x, tree)


def _jax_member_draws(key):
    """What one member's JAX update draws from its key (the order of
    tests/test_torch_rgb_slice.py's replay): noise (T, E, 1), perms
    (EPOCHS, T)."""
    noise, perms = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (E, 1), jnp.float32)))
    for _ in range(EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, T)))
    return np.stack(noise), np.stack(perms)


@pytest.fixture(scope="module")
def jax_population():
    """One JAX RGB population update from `pop_init(key(0))` on its
    batched step, float32 as in real runs: (initial TrainState, TrainState
    after, metrics)."""
    (jcfg, jtask), _ = _rgb_pair()
    jp = JPPOConfig(num_envs=E, rollout_steps=T, num_minibatches=MB,
                    update_epochs=EPOCHS)
    pinit, pupd, _, _ = j_population(jcfg, jtask, jp, K, env_path="batched")
    ts0 = _f32(jax.jit(pinit)(jax.random.key(0)))
    ts1, m = jax.jit(pupd)(ts0)
    return ts0, ts1, m


def test_population_update_matches_jax(jax_population):
    ts0, jts, jm = jax_population
    pinit, pupd, _, network = _population()
    assert pupd.env_path == "batched" and pupd.num_policies == K
    assert isinstance(network, PopulationActorCriticCNN)
    ts = pinit(torch.Generator().manual_seed(0))
    start = convert.population_cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, ts0.params))
    ts.network.load_state_dict(start)
    assert ts.last_obs.shape == (K, E, IMG)
    assert_obs_close(ts.last_obs, ts0.last_obs)
    replay = [_jax_member_draws(ts0.key[k]) for k in range(K)]
    draws = tppo.Draws(*(torch.from_numpy(np.stack(x)).to(dt) for x, dt in
                         zip(zip(*replay), (torch.float32, torch.long))))
    ts, tm = pupd(ts, draws)
    assert_obs_close(ts.last_obs, jts.last_obs)
    for q in METRICS:
        assert tm[q].shape == (K,)
        np.testing.assert_allclose(tm[q].numpy(), np.asarray(jm[q]),
                                   err_msg=q, **METRIC_TOL)
    want = convert.population_cnn_state_dict_from_flax(
        jax.tree.map(np.asarray, jts.params))
    got = ts.network.state_dict()
    moved = 0.0
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)
        moved = max(moved, float((v - start[name]).abs().max()))
    assert moved > 100 * PARAM_ATOL


def _draws(seed):
    rng = np.random.default_rng(seed)
    return tppo.Draws(
        torch.from_numpy(rng.normal(size=(K, T, E, 1)).astype(np.float32)),
        torch.from_numpy(np.stack([[rng.permutation(T)
                                    for _ in range(EPOCHS)]
                                   for _ in range(K)])))


def test_members_match_single_updates(monkeypatch):
    """Each member of one population update against `make_train`'s pixel
    update (`pop_update.single`) of its weights, Adam state, envs and
    draws (`member_state`); every control step is one K1 step and one
    render of all K x E cameras, and the trainer's construction renders
    one reset image (the single update's env is built at its first
    call)."""
    calls = []
    real = kernel_render.render_drones

    def counted(params, scene, pos, *args, **kw):
        calls.append(pos.shape[0])
        return real(params, scene, pos, *args, **kw)
    monkeypatch.setattr(kernel_render, "render_drones", counted)
    pinit, pupd, _, _ = _population()
    ts = pinit(torch.Generator().manual_seed(3))
    assert calls == [1]
    singles = [tpop.member_state(ts, k) for k in range(K)]
    assert all(isinstance(s.network, ActorCriticCNN) for s in singles)
    draws = _draws(4)
    calls.clear()
    ts, m = pupd(ts, draws)
    assert calls == [K * E] * T
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
        assert_obs_close(ts.last_obs[k], one.last_obs)
        got = tpop.member_state(ts, k)
        for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                        one.opt_state.mu + one.opt_state.nu):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4 * float(b.abs().max()))


def test_evaluate_is_each_members(monkeypatch):
    """pop_evaluate is (K, E), each row `make_train`'s evaluation of that
    member, one K1 step a control step for all members."""
    calls = []
    real = kernel_dyn.dyn_ctrl_step

    def counted(*args, **kw):
        calls.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(kernel_dyn, "dyn_ctrl_step", counted)
    pinit, _, pevaluate, _ = _population()
    ts = pinit(torch.Generator().manual_seed(1))
    got = pevaluate(ts.network.state_dict(), num_steps=6, episodic=True)
    assert got.shape == (K, E) and len(calls) == 6
    _, (tcfg, ttask) = _rgb_pair()
    _, _, evaluate, _ = tppo.make_train(tcfg, ttask, _ppo(), device="cpu")
    for k in range(K):
        want = evaluate(ts.network.member(k), num_steps=6, episodic=True)
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("case", ["two_drones", "fused"])
def test_rgb_population_refusals(case):
    """The CNN reads one drone's image, as `make_train` says for one
    policy; the fused kernel takes KIN observations only (`fused_spec`)."""
    if case == "two_drones":
        with pytest.raises(ValueError, match="one drone"):
            _population("multihover")
    else:
        with pytest.raises(ValueError, match="KIN"):
            _population(env_path="fused")


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """An RGB population's TrainState (the stacked CNN, Adam's stacked
    moments, the flat EnvState of K x E envs, the (K, E, 12288) images)
    saved after one update and restored into a fresh `pop_init`: one more
    update from each agrees bit for bit."""
    pinit, pupd, _, _ = _population()
    ts, _ = pupd(pinit(torch.Generator().manual_seed(0)))
    path = save_checkpoint(str(tmp_path / "ckpt"), ts, step=1)
    restored = restore_checkpoint(path, pinit(torch.Generator()
                                              .manual_seed(1)))
    a, ma = pupd(ts)
    b, mb = pupd(restored)
    for q in METRICS:
        assert torch.equal(ma[q], mb[q]), q
    state = lambda s: (list(s.network.state_dict().values())
                       + list(s.opt_state.mu) + list(s.opt_state.nu)
                       + leaves(s.env_state) + [s.last_obs])
    assert a.opt_state.count == b.opt_state.count == 2 * EPOCHS * MB
    for x, y in zip(state(a), state(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.network is not b.network
