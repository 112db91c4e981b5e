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
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

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

