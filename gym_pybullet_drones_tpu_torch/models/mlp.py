"""Actor-critic MLP policy (SB3 'MlpPolicy' semantics) in PyTorch.

Counterpart of the JAX package's `models/mlp.py`: separate pi and vf towers
of tanh units ((64, 64) by default), a state-independent log-std Gaussian
head, and orthogonal initialisation (gain sqrt(2) on the hidden layers,
0.01 on the policy head, 1.0 on the value head, zero biases), as
stable-baselines3's default MlpPolicy.  The products are plain
`nn.Linear` layers: the JAX package computes them as XLA `Dense` layers,
not in a Pallas kernel.

The flax module numbers its layers in call order (`Dense_0` ... the pi
tower and the mean head, then the vf tower and the value head);
`convert.actor_critic_state_dict_from_flax` carries such params into this
module's `state_dict`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


class ActorCritic(nn.Module):
    """Separate-tower actor-critic with a diagonal-Gaussian policy head.

    forward(obs (..., obs_dim)) -> (mean (..., action_dim), log_std
    (action_dim,), value (...)).  `generator` seeds the orthogonal init;
    the weights are drawn on the CPU, so one seed gives the same network
    on every device.
    """

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 log_std_init: float = 0.0, compute_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if compute_dtype is not None:
            raise NotImplementedError(
                "compute_dtype (bf16 Dense layers) is not ported yet: "
                "ROADMAP.md queue 1, item 18")
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.hidden = tuple(hidden)
        dims = (obs_dim,) + self.hidden
        self.pi = nn.ModuleList(nn.Linear(a, b)
                                for a, b in zip(dims[:-1], dims[1:]))
        self.mean = nn.Linear(dims[-1], action_dim)
        self.vf = nn.ModuleList(nn.Linear(a, b)
                                for a, b in zip(dims[:-1], dims[1:]))
        self.value = nn.Linear(dims[-1], 1)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), float(log_std_init)))
        with torch.no_grad():
            # call order of the flax module: pi tower, mean, vf tower, value
            for layer, gain in ([(l, math.sqrt(2)) for l in self.pi]
                                + [(self.mean, 0.01)]
                                + [(l, math.sqrt(2)) for l in self.vf]
                                + [(self.value, 1.0)]):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                nn.init.zeros_(layer.bias)

    def forward(self, obs: torch.Tensor):
        x = obs
        for layer in self.pi:
            x = torch.tanh(layer(x))
        v = obs
        for layer in self.vf:
            v = torch.tanh(layer(v))
        return self.mean(x), self.log_std, self.value(v).squeeze(-1)


def gaussian_log_prob(mean, log_std, action):
    """Diagonal-Gaussian log pdf summed over the action dimension."""
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std
                + math.log(2 * math.pi)), dim=-1)


def gaussian_entropy(log_std):
    """Entropy of the diagonal Gaussian (state-independent)."""
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
