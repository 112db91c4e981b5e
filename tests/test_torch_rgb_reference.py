"""The pixel trainer of the port against the benchmark's plain reference
(`portbench/reference/`: its camera `render.py` and its NatureCNN and PPO
update `cnn.py`), on the CPU, with seeded random weights and the
configuration `portbench/configs/hover_rgb.json` (Hover, DYN 240/30 Hz,
ONE_D_RPM, one drone's 48x64x4 camera, the NatureCNN at its published
widths).  The reference imports nothing of the port; the port's plain
versions run its kernels here.

- the reference camera against `kernel_render.render_drones_plain` on
  seeded poses, by the port's render check (rgba within 1 of 255 off a
  tie, ties at most 0.1% of pixels); both are the same float32
  operations in one written order, so they agree bit for bit;
- the reference NatureCNN forward against `ActorCriticCNN`, to 1e-6
  relative;
- one PPO update of `make_train` on the batched RGB path, 8 envs x 4
  steps, against the reference's from the same weights and draws;
- the reference stepping on from the program's env state;
- a reference whose last feature map is flattened in (c, h, w) order
  failing against the port.
"""
import copy
import json
import os

import pytest
import torch

from gym_pybullet_drones_tpu_torch.envs import fast
from gym_pybullet_drones_tpu_torch.models import ActorCriticCNN
from gym_pybullet_drones_tpu_torch.ops import kernel_render, render
from gym_pybullet_drones_tpu_torch.ops import render_check
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo

from portbench import check, port
from portbench.drivers import train as train_driver, train_rgb
from portbench.reference import cnn as ref_cnn, render as ref_render

SEED = 2 ** 31 + 407
E, T = 8, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, and the suite runs files side by side: one intra-op
    thread runs them faster than a pool that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def config():
    with open(os.path.join(os.path.dirname(__file__), "..", "portbench",
                           "configs", "hover_rgb.json")) as f:
        return json.load(f)


def poses(n, seed):
    """`n` cameras around the landmarks: positions in [-1.2, 1.2]^2 x
    [0.05, 1.5], attitudes within 0.6 rad of level."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand((n, 3), generator=g) * torch.tensor([2.4, 2.4, 1.45]) \
        - torch.tensor([1.2, 1.2, -0.05])
    quat = torch.cat([0.3 * torch.randn((n, 3), generator=g),
                      torch.ones((n, 1))], dim=1)
    return pos, quat / quat.norm(dim=1, keepdim=True)


def test_reference_camera_matches_the_port(config):
    from gym_pybullet_drones_tpu_torch import params as P
    pos, quat = poses(24, SEED)
    got = kernel_render.render_drones_plain(
        P.CF2X, render.landmark_scene(), pos, quat, 1)
    rgba, depth, seg = ref_render.render_drones(config, pos, quat, 1)
    rec = render_check.compare_render(
        "reference camera", got, (rgba, depth, seg), pos,
        render.camera_forward(quat), P.CF2X.l)
    assert rec["bitwise_equal"], rec
    # the poses see the ground and most landmarks, not only the sky
    ids = set(seg.unique().tolist())
    assert 0 in ids and len(ids & {1, 2, 3, 4}) >= 3


def weights_of(config, seed):
    return train_rgb.make_weights(config, seed, "cpu")


def port_cnn(config, weights):
    net = ActorCriticCNN(1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(weights[k])
    return net


def test_reference_forward_matches_the_port(config):
    """To 1e-6 relative (measured: equal): both run the same float32
    convolutions on the same contiguous NCHW images on the CPU; the
    port's dense layers are `addmm`, the reference's a product and an
    add, which may round the bias in once more."""
    weights = weights_of(config, SEED)
    assert sorted(weights) == sorted(n for n, _ in port_cnn(
        config, weights).named_parameters())
    obs = 255.0 * torch.rand((6, 48 * 64 * 4),
                             generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        mean, log_std, value = port_cnn(config, weights)(obs)
        rmean, rlog_std, rvalue = ref_cnn.forward(weights, obs, config)
    for got, ref in ((mean, rmean), (value, rvalue)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-6
    assert torch.equal(log_std, rlog_std)


def test_reference_flattened_chw_fails(config):
    """SB3's own flatten order, (c, h, w), with the port's weights is
    another function: the comparison above tells them apart by far."""
    weights = weights_of(config, SEED)
    chw = copy.deepcopy(config)
    chw["policy"]["flatten"] = "chw"
    obs = 255.0 * torch.rand((6, 48 * 64 * 4),
                             generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, _, value = port_cnn(config, weights)(obs)
        _, _, rvalue = ref_cnn.forward(weights, obs, chw)
    assert float((value - rvalue).abs().max() / rvalue.abs().max()) > 1e-2


def test_param_shapes_are_the_published_widths(config):
    shapes = ref_cnn.param_shapes(config)
    assert shapes["convs.0.weight"] == (32, 4, 8, 8)
    assert shapes["convs.1.weight"] == (64, 32, 4, 4)
    assert shapes["convs.2.weight"] == (64, 64, 3, 3)
    # 48x64 -> 11x15 -> 4x6 -> 2x4, 64 channels: 512 features
    assert shapes["dense.weight"] == (512, 512)
    assert shapes["mean.weight"] == (1, 512) and shapes["log_std"] == (1,)


class _Cell:
    def __init__(self, config, **traffic):
        self.config = config
        self.traffic = {"num_envs": E, "rollout_steps": T, "ranks": 1,
                        "check_updates": 1, **traffic}


@pytest.fixture(scope="module")
def one_update(config):
    """One update of the port's trainer and of the reference from the
    benchmark's weights and draws: (program's (metrics, mu1, change),
    the reference's)."""
    cell = _Cell(config)
    update, ts, named = train_rgb.build(cell, SEED, "cpu")
    assert isinstance(ts.env_state, tuple)     # the batched path's state
    start = {k: p.detach().clone() for k, p in named.items()}
    gen = torch.Generator().manual_seed(SEED ^ train_driver.NAMES_SEED_MIX)
    draws = tppo.Draws(*train_driver.make_draws(
        gen, T, E, 1, int(config["ppo"]["update_epochs"]), "cpu"))
    ts, metrics = update(ts, draws)
    prog = {"metrics": [{k: float(v) for k, v in metrics.items()}],
            "mu1": dict(zip(named, ts.opt_state.mu)),
            "change": {k: p.detach() - start[k] for k, p in named.items()}}
    return prog, train_rgb.reference_updates(cell, SEED, "cpu")


def test_one_update_loss_matches_the_reference(config, one_update):
    """The loss within 1e-6 relative (measured 1.1e-7): the images agree
    bit for bit and the CNN's outputs too, the rewards within float32
    rounding (a norm to the fourth power against a squared distance
    squared), and the loss terms are float32 sums in another order."""
    prog, ref = one_update
    assert max(check.loss_gaps(prog, ref, config["ppo"])) < 1e-6
    for k in ("mean_reward", "mean_value", "v_loss", "entropy"):
        a, b = prog["metrics"][0][k], ref["metrics"][0][k]
        assert a == pytest.approx(b, rel=1e-6), k


def test_one_update_gradient_and_change_match_the_reference(config,
                                                             one_update):
    """Adam's first moment within 3e-5 and the parameters' change within
    1e-5 per tensor, of the larger of the tensor's and the median
    tensor's norm (`check.leaf_gaps`; measured 2.8e-6 and 5.4e-7): the
    eight minibatch steps' gradients are float32 sums in another order,
    and Adam's first step moves a weight whose gradient is within
    rounding of zero by the learning rate either way."""
    prog, ref = one_update
    assert check.leaf_gaps(prog["mu1"], ref["mu1"]) < 3e-5
    assert check.leaf_gaps(prog["change"], ref["change"],
                           check.quiet_leaves(ref["mu1"])) < 1e-5
    # and the update moved every tensor
    assert all(float(v.abs().max()) > 0 for v in prog["change"].values())


def test_reference_steps_on_from_the_program_state(config):
    """The reference's carry, made from the program's flat env state after
    a few batched steps, steps on as the program does: state rows within
    tests/test_fused.py's 2e-5 / 1e-4, images bit for bit."""
    cfg, task = port.build(config)
    reset_fn, step_fn = fast.make_batched_step(cfg, task, E,
                                               obs_layout="flat",
                                               device="cpu")
    state, obs = reset_fn()
    g = torch.Generator().manual_seed(SEED)
    acts = torch.randn((4, E, 1, 1), generator=g)
    for t in range(3):
        state, obs, *_ = step_fn(state, acts[t])
    env = ref_cnn.RgbEnv(config)
    carry = env.carry_of(train_rgb.env_state(state))
    assert torch.equal(env.images(carry).t(), obs)
    new, outs = env.step(carry, acts[3].reshape(E, 1).t().contiguous())
    state, obs, reward, term, trunc = step_fn(state, acts[3])
    ref_state = torch.cat([state.pos, state.quat, state.vel,
                           state.rpy_rates, state.ang_v], dim=1).t()
    torch.testing.assert_close(new[:16], ref_state, atol=2e-5, rtol=1e-4)
    ro = env.obs_rows_per
    assert torch.equal(outs[:ro].t(), obs)
    torch.testing.assert_close(outs[ro], reward, atol=2e-5, rtol=1e-4)
    assert torch.equal(outs[ro + 1] > 0.5, term)
    assert torch.equal(outs[ro + 2] > 0.5, trunc)
    assert torch.equal(new[-1], state.step_counter.float())
