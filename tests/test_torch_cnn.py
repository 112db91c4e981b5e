"""The port's NatureCNN actor-critic (gym_pybullet_drones_tpu_torch/models/
cnn.py) against the JAX package's flax `ActorCriticCNN`, on the CPU.

The flax params are carried across with
`convert.actor_critic_cnn_state_dict_from_flax`; the forward pass must agree
on flat (E, 48*64*4) rows and on (E, 48, 64, 4) images to atol 1e-6 / rtol
1e-5 on the mean and 2e-6 / 1e-5 on the value (float32 sums over 2.7 M
multiply-adds an image; measured 8e-9 and 8e-7).  One case holds the
flatten order: the last feature map is 2 x 4 x 64, flattened (h, w, c) by
flax and (c, h, w) by a plain NCHW flatten, and a converter that forgot it
is far outside the tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.models import cnn as jcnn

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.models import cnn as tcnn

MEAN_TOL = dict(atol=1e-6, rtol=1e-5)
VALUE_TOL = dict(atol=2e-6, rtol=1e-5)
E = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, and the suite runs files side by side: one intra-op
    thread runs them faster than a pool that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def flax_pair():
    """Flax params for 4 and 1 actions, their torch modules, and images."""
    obs = np.random.default_rng(0).uniform(
        0, 255, size=(E, 48 * 64 * 4)).astype(np.float32)
    out = {}
    for act in (4, 1):
        net = jcnn.ActorCriticCNN(action_dim=act)
        params = jax.jit(net.init)(jax.random.key(act),
                                   jnp.asarray(obs[:1]))
        params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
        tnet = tcnn.ActorCriticCNN(act)
        tnet.load_state_dict(
            convert.actor_critic_cnn_state_dict_from_flax(params))
        out[act] = (net, params, tnet)
    return obs, out


@pytest.mark.parametrize("act", [4, 1])
@pytest.mark.parametrize("layout", ["flat", "image"])
def test_forward_matches_flax(flax_pair, act, layout):
    obs, nets = flax_pair
    net, params, tnet = nets[act]
    x = obs if layout == "flat" else obs.reshape(E, 48, 64, 4)
    jm, jl, jv = (np.asarray(v) for v in jax.jit(net.apply)(params, x))
    with torch.no_grad():
        tm, tl, tv = (v.numpy() for v in tnet(torch.from_numpy(x)))
    assert tm.shape == jm.shape == (E, act) and tv.shape == jv.shape == (E,)
    np.testing.assert_allclose(tm, jm, **MEAN_TOL)
    np.testing.assert_allclose(tv, jv, **VALUE_TOL)
    np.testing.assert_array_equal(tl, jl)


def test_flatten_order_matters(flax_pair):
    """Dense_0's 512 input rows in NCHW flatten order instead of flax's
    (h, w, c): the outputs leave the tolerance by far, so the forward test
    above holds the order."""
    obs, nets = flax_pair
    net, params, tnet = nets[4]
    sd = convert.actor_critic_cnn_state_dict_from_flax(params)
    # what a converter that ignored the order would load: the (h, w, c)
    # rows of the flax kernel read as (c, h, w)
    w = sd["dense.weight"]                              # (512, 2*4*64)
    sd["dense.weight"] = w.reshape(512, 2, 4, 64).permute(0, 3, 1, 2) \
        .reshape(512, 512)
    wrong = tcnn.ActorCriticCNN(4)
    wrong.load_state_dict(sd)
    jm, _, jv = (np.asarray(v) for v in jax.jit(net.apply)(params, obs))
    with torch.no_grad():
        m, _, v = wrong(torch.from_numpy(obs))
    assert np.abs(v.numpy() - jv).max() > 1e3 * VALUE_TOL["atol"]
    assert np.abs(m.numpy() - jm).max() > 1e2 * MEAN_TOL["atol"]


def test_layers_and_init_match_flax_shapes(flax_pair):
    """The same parameters as the flax module, initialised as it is:
    orthogonal with gains sqrt(2) / 0.01 / 1.0, zero biases, log_std 0."""
    _, nets = flax_pair
    _, params, _ = nets[4]
    net = tcnn.ActorCriticCNN(4, generator=torch.Generator().manual_seed(3))
    n_flax = sum(x.size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in net.parameters()) == n_flax
    assert torch.equal(net.log_std, torch.zeros(4))
    for layer, gain in ([(c, math.sqrt(2)) for c in net.convs]
                        + [(net.dense, math.sqrt(2)), (net.mean, 0.01),
                           (net.value, 1.0)]):
        w = layer.weight.detach().reshape(layer.weight.shape[0], -1)
        g = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(g.numpy(), gain ** 2 * np.eye(len(g)),
                                   atol=1e-5)
        assert torch.equal(layer.bias, torch.zeros_like(layer.bias))
    again = tcnn.ActorCriticCNN(4, generator=torch.Generator().manual_seed(3))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_ieee_scope_restores_the_setting():
    conv = torch.backends.cudnn.conv
    before = conv.fp32_precision
    with tcnn.ieee_fp32_convs():
        assert conv.fp32_precision == "ieee"
    assert conv.fp32_precision == before
