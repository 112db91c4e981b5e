"""Convolutional actor-critic for RGB observations (SB3 'CnnPolicy' shape).

Counterpart of the JAX package's `models/cnn.py`: a NatureCNN trunk
(32/64/64 channels: 8x8 stride 4, 4x4 stride 2, 3x3 stride 1, all VALID,
ReLU), a 512-wide dense layer, a Gaussian mean head and a value head on
that trunk, and a state-independent log-std.  It reads the (N, 48, 64, 4)
camera images of `ops/render.py`, or their flattened HWC rows, in [0, 255]
and scales them by 1/255 inside.  The products are cuDNN convolutions and
`nn.Linear`: the JAX package computes them as XLA convolutions and `Dense`
layers, not in a Pallas kernel.

Layout: an image batch (E, H, W, C) is copied to a contiguous NCHW tensor
for cuDNN, and the last feature map is flattened in (h, w, c) order, as
flax flattens its NHWC map, so the flax weights carry across as a pure
transpose of each kernel (`convert.actor_critic_cnn_state_dict_from_flax`).
The channels-last view that a plain `permute` gives would save the copy,
but in IEEE float32 cuDNN then converts between layouts inside the
backward pass, which on an H100 took longer than the copy.

Precision: on the card every convolution of this module runs in IEEE
float32 (`ieee_fp32_convs`), not in TF32, the default of cuDNN
convolutions: the JAX reference it is held against is float32, and
`rl/ppo.py` takes the backward pass under the same scope.

`PopulationActorCriticCNN` stacks K such networks on a leading member
axis, as `jax.vmap` of the flax module does: each trunk convolution is ONE
grouped convolution (`groups=K`) over the K members' images, what XLA's
batching rule makes of a vmapped `Conv` (a feature-group count), and each
dense layer one batched product (`models.mlp._StackedLinear`).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from gym_pybullet_drones_tpu_torch.models.mlp import (
    _MemberStack, _StackedLinear)
from gym_pybullet_drones_tpu_torch.ops.render import IMAGE_SHAPE

TRUNK = ((32, 8, 4), (64, 4, 2), (64, 3, 1))   # (channels, kernel, stride)


@contextlib.contextmanager
def ieee_fp32_convs():
    """cuDNN convolutions in IEEE float32 (no TF32) inside the scope; the
    previous setting comes back on exit.  Only the precision API
    (`cudnn.conv.fp32_precision`) is touched: torch refuses a mix of it
    and the older `allow_tf32` flags."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def _out_size(size: int) -> int:
    for _, kernel, stride in TRUNK:
        size = (size - kernel) // stride + 1
    return size


class ActorCriticCNN(nn.Module):
    """NatureCNN trunk + Gaussian policy / value heads.

    forward(obs (..., H*W*C) or (..., H, W, C)) -> (mean (..., action_dim),
    log_std (action_dim,), value (...)).  `generator` seeds the orthogonal
    init (gains sqrt(2) on the trunk, 0.01 on the mean head, 1.0 on the
    value head; zero biases, log_std zeros), drawn on the CPU, so one seed
    gives the same network on every device.  Like the JAX model it has no
    `hidden` or `log_std_init` to set.
    """

    def __init__(self, action_dim: int, image_shape=IMAGE_SHAPE,
                 hidden: int = 512, generator: torch.Generator | None = None):
        super().__init__()
        self.action_dim = action_dim
        self.image_shape = tuple(image_shape)
        h, w, c = self.image_shape
        chans = (c,) + tuple(ch for ch, _, _ in TRUNK)
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, kernel, stride)
            for a, (b, kernel, stride) in zip(chans[:-1], TRUNK))
        flat = _out_size(h) * _out_size(w) * chans[-1]
        self.dense = nn.Linear(flat, hidden)
        self.mean = nn.Linear(hidden, action_dim)
        self.value = nn.Linear(hidden, 1)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        with torch.no_grad():
            # call order of the flax module: Conv_0..2, Dense_0 (trunk),
            # Dense_1 (mean), Dense_2 (value)
            for layer, gain in ([(l, math.sqrt(2)) for l in self.convs]
                                + [(self.dense, math.sqrt(2)),
                                   (self.mean, 0.01), (self.value, 1.0)]):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor):
        h, w, c = self.image_shape
        lead = obs.shape[:-1] if obs.shape[-1] == h * w * c \
            else obs.shape[:-3]
        x = obs.reshape((-1, h, w, c)).permute(0, 3, 1, 2).contiguous() \
            / 255.0
        with ieee_fp32_convs():
            for conv in self.convs:
                x = torch.relu(conv(x))
        # flatten in (h, w, c) order, as flax flattens its NHWC map
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        trunk = torch.relu(self.dense(x))
        mean = self.mean(trunk).reshape(lead + (self.action_dim,))
        value = self.value(trunk).reshape(lead)
        return mean, self.log_std, value


class _GroupedConv(nn.Module):
    """K `nn.Conv2d` layers of one shape: weight (K, out, in, kh, kw), bias
    (K, out); forward maps (M, K*in, H, W) to (M, K*out, H', W') in one
    grouped convolution, member k's channels the k-th block of each."""

    def __init__(self, layers):
        super().__init__()
        self.stride = layers[0].stride
        self.weight = nn.Parameter(torch.stack(
            [l.weight.detach() for l in layers]).clone())
        self.bias = nn.Parameter(torch.stack(
            [l.bias.detach() for l in layers]).clone())

    def forward(self, x: torch.Tensor):
        K = self.weight.shape[0]
        return F.conv2d(x, self.weight.flatten(0, 1), self.bias.flatten(),
                        self.stride, groups=K)


class PopulationActorCriticCNN(_MemberStack):
    """K `ActorCriticCNN`s of one shape, stacked on a leading member axis.

    forward(obs (K, M, H*W*C) or (K, M, H, W, C)) -> (mean (K, M,
    action_dim), log_std (K, 1, action_dim), value (K, M)): member k's
    outputs are what its own `ActorCriticCNN` gives on obs[k].  Parameters
    and `state_dict` keys are `ActorCriticCNN`'s with a leading K axis
    (dense biases (K, 1, out)).  `generators` (one per member) seed the
    members' orthogonal inits: member k is the `ActorCriticCNN` that
    generators[k] would give.  `from_members` stacks given networks,
    `member(k)` copies one out.

    The images of all members are copied once into one (M, K*C, H, W)
    tensor, member-major along the channels, so each trunk layer is one
    grouped convolution; the last feature map (M, K*64, h, w) is flattened
    per member in (h, w, c) order, as each member's flax module flattens
    its NHWC map.
    """

    def __init__(self, num_members: int, action_dim: int,
                 image_shape=IMAGE_SHAPE, hidden: int = 512,
                 generators=None):
        super().__init__()
        if generators is None:
            generators = [None] * num_members
        if len(generators) != num_members:
            raise ValueError(f"{len(generators)} generators for "
                             f"{num_members} members")
        self._stack([ActorCriticCNN(action_dim, image_shape, hidden,
                                    generator=g) for g in generators])

    def _stack(self, members):
        m0 = members[0]
        shape = (m0.action_dim, m0.image_shape, m0.dense.out_features)
        if any((m.action_dim, m.image_shape, m.dense.out_features) != shape
               for m in members):
            raise ValueError("the members differ in shape")
        self.num_members = len(members)
        self.action_dim, self.image_shape, self.hidden = shape
        # registered in ActorCriticCNN's order, so that parameters() lines
        # up with a member's
        self.convs = nn.ModuleList(
            _GroupedConv([m.convs[i] for m in members])
            for i in range(len(m0.convs)))
        self.dense = _StackedLinear([m.dense for m in members])
        self.mean = _StackedLinear([m.mean for m in members])
        self.value = _StackedLinear([m.value for m in members])
        self.log_std = nn.Parameter(torch.stack(
            [m.log_std.detach() for m in members]).clone())

    def member(self, k: int) -> ActorCriticCNN:
        """A copy of member k as an `ActorCriticCNN`, on this module's
        device."""
        return self._member_into(ActorCriticCNN(
            self.action_dim, self.image_shape, self.hidden,
            generator=torch.Generator()), k)

    def forward(self, obs: torch.Tensor):
        K, M = obs.shape[:2]
        h, w, c = self.image_shape
        # (K, M, H, W, C) -> (M, K*C, H, W): one copy, then the scale
        x = obs.reshape(K, M, h, w, c).permute(1, 0, 4, 2, 3) \
            .reshape(M, K * c, h, w) / 255.0
        with ieee_fp32_convs():
            for conv in self.convs:
                x = torch.relu(conv(x))
        # (M, K*C', h', w') -> (K, M, h'*w'*C'), each member's map
        # flattened in (h, w, c) order
        x = x.reshape(M, K, -1, *x.shape[2:]).permute(1, 0, 3, 4, 2) \
            .reshape(K, M, -1)
        trunk = torch.relu(self.dense(x))
        return (self.mean(trunk), self.log_std[:, None, :],
                self.value(trunk).squeeze(-1))
