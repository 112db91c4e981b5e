"""The port's actor-critic MLP (gym_pybullet_drones_tpu_torch/models/mlp.py)
against the JAX package's flax module, on the CPU.

The flax params are carried across with
`convert.actor_critic_state_dict_from_flax`; the forward pass must agree
to atol 1e-6 / rtol 1e-5 (float32 products of 64-wide layers), the
Gaussian log-prob and entropy to atol 1e-5 (the JAX side's log(2 pi) is a
float64 constant under the suite's x64).  The torch init is held by its
properties, not by its draws: torch and jax.random draw different numbers.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.models import mlp as jmlp

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.models import mlp as tmlp

OBS_DIM = 72
FWD_TOL = dict(atol=1e-6, rtol=1e-5)
DIST_ATOL = 1e-5
CASES = [((64, 64), 4), ((64, 64), 1), ((32, 32), 4), ((32, 32), 1)]
IDS = [f"{h[0]}x{h[1]}-act{a}" for h, a in CASES]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These tensors are small: one intra-op thread runs them faster than
    a pool of threads that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _batch(seed, rows=16, dim=OBS_DIM):
    return np.random.default_rng(seed).normal(
        size=(rows, dim)).astype(np.float32)


@pytest.mark.parametrize("hidden,act_dim", CASES, ids=IDS)
def test_forward_matches_flax(hidden, act_dim):
    jnet = jmlp.ActorCritic(action_dim=act_dim, hidden=hidden,
                            log_std_init=-0.5)
    params = jax.jit(jnet.init)(jax.random.key(3),
                                jnp.zeros((1, OBS_DIM), jnp.float32))
    tnet = tmlp.ActorCritic(OBS_DIM, act_dim, hidden, log_std_init=-0.5)
    tnet.load_state_dict(convert.actor_critic_state_dict_from_flax(
        jax.tree.map(np.asarray, params)))
    obs = _batch(7)
    jm, jl, jv = (np.asarray(x) for x in jax.jit(jnet.apply)(params, obs))
    with torch.no_grad():
        tm, tl, tv = (x.numpy() for x in tnet(torch.from_numpy(obs)))
    assert tm.shape == jm.shape == (16, act_dim)
    assert tv.shape == jv.shape == (16,)
    np.testing.assert_allclose(tm, jm, **FWD_TOL)
    np.testing.assert_allclose(tl, jl, **FWD_TOL)
    np.testing.assert_allclose(tv, jv, **FWD_TOL)


@pytest.mark.parametrize("act_dim", [4, 1])
def test_gaussian_log_prob_and_entropy_match_jax(act_dim):
    rng = np.random.default_rng(11)
    mean, action = (rng.normal(size=(32, act_dim)).astype(np.float32)
                    for _ in range(2))
    log_std = (0.3 * rng.normal(size=(act_dim,))).astype(np.float32)
    jl = np.asarray(jmlp.gaussian_log_prob(mean, log_std, action))
    tl = tmlp.gaussian_log_prob(*(torch.from_numpy(x)
                                  for x in (mean, log_std, action)))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=DIST_ATOL)
    je = float(jmlp.gaussian_entropy(log_std))
    te = float(tmlp.gaussian_entropy(torch.from_numpy(log_std)))
    assert abs(te - je) <= DIST_ATOL


@pytest.mark.parametrize("hidden", [(64, 64), (32, 32)])
def test_torch_init_properties(hidden):
    net = tmlp.ActorCritic(OBS_DIM, 4, hidden, log_std_init=-1.0,
                           generator=torch.Generator().manual_seed(5))
    gains = [math.sqrt(2)] * len(hidden) + [0.01] \
        + [math.sqrt(2)] * len(hidden) + [1.0]
    layers = list(net.pi) + [net.mean] + list(net.vf) + [net.value]
    for layer, gain in zip(layers, gains, strict=True):
        w = layer.weight.detach().double()
        # orthogonal: every singular value equals the gain
        sv = torch.linalg.svdvals(w)
        np.testing.assert_allclose(sv.numpy(), gain, rtol=1e-5, atol=0)
        assert torch.count_nonzero(layer.bias) == 0
    assert torch.equal(net.log_std.detach(), torch.full((4,), -1.0))
    twin = tmlp.ActorCritic(OBS_DIM, 4, hidden, log_std_init=-1.0,
                            generator=torch.Generator().manual_seed(5))
    other = tmlp.ActorCritic(OBS_DIM, 4, hidden, log_std_init=-1.0,
                             generator=torch.Generator().manual_seed(6))
    for k, v in net.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    assert not torch.equal(net.pi[0].weight, other.pi[0].weight)


def test_compute_dtype_not_ported():
    """Named for what it checked before `compute_dtype` was ported: now
    the bf16 forward pass against flax's `ActorCritic(compute_dtype=
    jnp.bfloat16)`.  Both round every product, bias add and tanh to bf16
    and cast mean and value back to float32; measured on the CPU the two
    agree bit for bit, held here to one bf16 step (2^-8) of each output's
    scale.  Every output must be a bf16 number (the float32 forward's are
    not), and the stacked population's bf16 forward its members' own."""
    jnet = jmlp.ActorCritic(action_dim=4, hidden=(64, 64),
                            log_std_init=-0.5, compute_dtype=jnp.bfloat16)
    params = jax.jit(jnet.init)(jax.random.key(3),
                                jnp.zeros((1, OBS_DIM), jnp.float32))
    tnet = tmlp.ActorCritic(OBS_DIM, 4, (64, 64), log_std_init=-0.5,
                            compute_dtype=torch.bfloat16)
    sd = convert.actor_critic_state_dict_from_flax(
        jax.tree.map(np.asarray, params))
    tnet.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    obs = _batch(7, rows=64)
    jm, jl, jv = (np.asarray(x) for x in jax.jit(jnet.apply)(params, obs))
    with torch.no_grad():
        tm, tl, tv = tnet(torch.from_numpy(obs))
        f32 = tmlp.ActorCritic(OBS_DIM, 4, (64, 64), log_std_init=-0.5)
        f32.load_state_dict(sd)
        fm, _, fv = f32(torch.from_numpy(obs))
    assert tm.dtype == tv.dtype == tl.dtype == torch.float32
    for got, want, full in ((tm, jm, fm), (tv, jv, fv)):
        step = 2.0 ** -8 * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=step)
        # computed in bf16: every output is a bf16 number, unlike float32's
        assert torch.equal(got, got.bfloat16().float())
        assert not torch.equal(full, full.bfloat16().float())
    np.testing.assert_array_equal(tl.detach().numpy(), jl)
    with pytest.raises(ValueError):
        tmlp.PopulationActorCritic.from_members([tnet, f32])
    pop = tmlp.PopulationActorCritic.from_members([tnet, tnet])
    with torch.no_grad():
        pm, pl, pv = pop(torch.from_numpy(np.stack([obs, obs])))
    for k in range(2):
        np.testing.assert_array_equal(pm[k].numpy(), tm.numpy())
        np.testing.assert_array_equal(pv[k].numpy(), tv.numpy())
        np.testing.assert_array_equal(pl[k, 0].detach().numpy(), jl)


def test_convert_rejects_other_trees():
    with pytest.raises(ValueError):
        convert.actor_critic_state_dict_from_flax(
            {"params": {"Dense_0": {"kernel": np.zeros((2, 2)),
                                    "bias": np.zeros(2)}}})
