"""The plain reference of pixel PPO: the NatureCNN actor-critic, the DYN
hover with camera observations, and a PPO update over them, in float32
plain PyTorch with TF32 off.

The policy follows Mnih et al., "Human-level control through deep
reinforcement learning" (Nature 518, 2015) as Stable-Baselines3's
`CnnPolicy` builds it (`NatureCNN`, features_dim 512): images in [0, 255]
scaled by 1/255, three VALID convolutions with ReLU ((32, 8, 4), (64, 4,
2), (64, 3, 1): channels, kernel, stride), the last map flattened, a
dense layer of 512 with ReLU, then a Gaussian mean head and a value head,
each one linear layer, and a state-independent log-std.  Departure,
written in the configuration's `assumed`: the map is flattened in (h, w,
c) order (the configuration's `policy.flatten`), where SB3 flattens (c,
h, w).  Everything is read from the configuration file; weights and
draws come from the benchmark.

Precision: convolutions through the precision API
(`torch.backends.cudnn.conv.fp32_precision = "ieee"`; torch refuses a mix
of it and the older `allow_tf32` flags on one backend, so cuDNN's are not
touched), matrix products with `torch.backends.cuda.matmul.allow_tf32`
False, for the forward and the backward pass (`float32`).

The env is `ref_env`'s DYN hover (`rows.fused_env_step_plain`: the
action mapping, the substeps, the reward and flags, the auto-reset) with
its observation replaced by each drone's image of the selected state
(`reference/render.py`).  The PPO update is `ppo.RefTrainer`'s, with the
CNN as its network.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.reference import ppo, ref_env
from portbench.reference import render as ref_render


@contextlib.contextmanager
def float32():
    """IEEE float32 convolutions and matrix products inside the scope."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision, torch.backends.cuda.matmul.allow_tf32
    conv.fp32_precision = "ieee"
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        conv.fp32_precision, torch.backends.cuda.matmul.allow_tf32 = prev


def param_shapes(config: dict) -> dict:
    """The policy's parameters by name, in the order the benchmark makes
    them: each convolution's (out, in, k, k) weight and bias, the dense
    layer's, the mean head's, the value head's, then log_std."""
    pol = config["policy"]
    h, w, c = (int(x) for x in pol["image"])
    env = config["env"]
    act = ref_env.ACT_DIMS[ref_env.ActionType(env["task"]["act"])] \
        * int(env["num_drones"])
    shapes = {}
    for i, (ch, k, s) in enumerate(pol["trunk"]):
        shapes[f"convs.{i}.weight"] = (ch, c, k, k)
        shapes[f"convs.{i}.bias"] = (ch,)
        h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
    dense = int(pol["dense"])
    shapes["dense.weight"] = (dense, h * w * c)
    shapes["dense.bias"] = (dense,)
    shapes["mean.weight"] = (act, dense)
    shapes["mean.bias"] = (act,)
    shapes["value.weight"] = (1, dense)
    shapes["value.bias"] = (1,)
    shapes["log_std"] = (act,)
    return shapes


def forward(p: dict, obs: torch.Tensor, config: dict):
    """(mean (M, A), log_std (A,), value (M,)) of the NatureCNN with
    parameters `p` on images `obs` (M, H*W*C) in HWC order."""
    pol = config["policy"]
    h, w, c = (int(x) for x in pol["image"])
    x = obs.reshape(-1, h, w, c).permute(0, 3, 1, 2).contiguous() \
        / float(pol["pixel_scale"])
    for i, (_, _, s) in enumerate(pol["trunk"]):
        x = torch.relu(F.conv2d(x, p[f"convs.{i}.weight"],
                                p[f"convs.{i}.bias"], stride=s))
    if pol["flatten"] == "hwc":
        x = x.permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ p["dense.weight"].t() + p["dense.bias"])
    mean = x @ p["mean.weight"].t() + p["mean.bias"]
    value = x @ p["value.weight"].t() + p["value.bias"]
    return mean, p["log_std"], value[:, 0]


class RgbEnv:
    """`ref_env`'s env with camera observations: obs rows (H*W*C, B), one
    drone an env."""

    def __init__(self, config: dict):
        self.config, self.rows = config, ref_env.make(config)
        if self.rows.n != 1:
            raise ValueError("the CNN reads one drone's image: one drone "
                             "an env")
        h, w, c = (int(x) for x in config["policy"]["image"])
        self.n, self.act_dim = 1, self.rows.act_dim
        self.obs_rows_per = h * w * c

    def images(self, carry: torch.Tensor) -> torch.Tensor:
        """The image rows (D, B) of the carry's state."""
        rgba, _, _ = ref_render.render_drones(
            self.config, carry[0:3].t(), carry[3:7].t(), 1)
        return rgba.t()

    def reset(self, b: int, device):
        carry, _ = self.rows.reset(b, device)
        return carry, self.images(carry)

    def step(self, carry: torch.Tensor, action_rows: torch.Tensor):
        """carry (RC, B), action rows (A, B) -> (carry', outs): the image
        rows of the selected state, then reward, terminated and truncated
        rows."""
        carry, outs = self.rows.step(carry, action_rows)
        ro = self.rows.n * self.rows.obs_rows_per
        return carry, torch.cat([self.images(carry), outs[ro:ro + 3]])

    def carry_of(self, state: dict) -> torch.Tensor:
        """The reference's carry (RC, B) of a program's flat state: `pos`,
        `quat`, `vel`, `rpy_rates`, `ang_v`, `last_rpm` (B, k), the ring
        `action_buffer` (B, rows) and the substep counter `step_counter`
        (B,)."""
        cols = [state[k].float() for k in ("pos", "quat", "vel", "rpy_rates",
                                           "ang_v", "last_rpm",
                                           "action_buffer")]
        carry = torch.cat(cols + [state["step_counter"].float()[:, None]],
                          dim=1).t().contiguous()
        if carry.shape[0] != self.rows.carry_rows:
            raise ValueError(f"a state of {carry.shape[0]} rows for a "
                             f"carry of {self.rows.carry_rows}")
        return carry


class RefTrainer(ppo.RefTrainer):
    """`ppo.RefTrainer` with the NatureCNN for its network, on an
    `RgbEnv`; every update in IEEE float32 (`float32`), rollout, loss and
    gradient alike.  `num_hidden` is unused."""

    def net(self, obs):
        return forward(self.params, obs, self.env.config)

    def update(self, noise, perms) -> dict:
        with float32():
            return super().update(noise, perms)
