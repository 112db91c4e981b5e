"""Actor-critic MLP policy (SB3 'MlpPolicy' semantics) in PyTorch.

Counterpart of the JAX package's `models/mlp.py`: separate pi and vf towers
of tanh units ((64, 64) by default), a state-independent log-std Gaussian
head, and orthogonal initialisation (gain sqrt(2) on the hidden layers,
0.01 on the policy head, 1.0 on the value head, zero biases), as
stable-baselines3's default MlpPolicy.  The products are plain
`nn.Linear` layers: the JAX package computes them as XLA `Dense` layers,
not in a Pallas kernel.

`compute_dtype=torch.bfloat16` does what flax's `Dense(dtype=bf16)` does
in the JAX module: every layer casts its input, kernel and bias to bf16,
the product, the bias add and `tanh` run in bf16, and `mean` and `value`
are cast back to float32.  The parameters stay float32 master weights
(autograd's gradients are float32), `log_std` among them.  The casts are
written out per layer rather than left to `torch.autocast`, whose per-op
policy (`tanh`, the bias add) is not flax's and differs between devices.

`PopulationActorCritic` stacks K such networks on a leading member axis:
each layer is one batched product (`torch.baddbmm`) over the K members.

The flax module numbers its layers in call order (`Dense_0` ... the pi
tower and the mean head, then the vf tower and the value head);
`convert.actor_critic_state_dict_from_flax` carries such params into this
module's `state_dict`, `convert.population_state_dict_from_flax` a stack
of them into `PopulationActorCritic`'s.
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
    on every device.  `compute_dtype` (None or a torch dtype such as
    `torch.bfloat16`) is the dtype the layers compute in.
    """

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 log_std_init: float = 0.0, compute_dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.obs_dim, self.action_dim = obs_dim, action_dim
        self.hidden = tuple(hidden)
        self.log_std_init = float(log_std_init)
        self.compute_dtype = compute_dtype
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
        cd = self.compute_dtype
        dense = (lambda layer, x: layer(x)) if cd is None else (
            lambda layer, x: x @ layer.weight.to(cd).t() + layer.bias.to(cd))
        # leading dims folded into rows: a strided (1, E, D) view, as the
        # trainer passes its observations, stays one product with its bias
        lead = obs.shape[:-1]
        x = v = obs.reshape(-1, self.obs_dim) if cd is None \
            else obs.reshape(-1, self.obs_dim).to(cd)
        for layer in self.pi:
            x = torch.tanh(dense(layer, x))
        for layer in self.vf:
            v = torch.tanh(dense(layer, v))
        mean, value = dense(self.mean, x), dense(self.value, v)
        if cd is not None:
            mean, value = mean.float(), value.float()
        return (mean.reshape(lead + (self.action_dim,)), self.log_std,
                value.reshape(lead))


class _StackedLinear(nn.Module):
    """K `nn.Linear` layers of one shape: weight (K, out, in), bias (K, 1,
    out); forward maps (K, M, in) to (K, M, out) in one batched product."""

    def __init__(self, layers: Sequence[nn.Linear]):
        super().__init__()
        self.weight = nn.Parameter(torch.stack(
            [l.weight.detach() for l in layers]).clone())
        self.bias = nn.Parameter(torch.stack(
            [l.bias.detach() for l in layers])[:, None, :].clone())

    def forward(self, x: torch.Tensor, cd=None):
        if cd is None:
            return torch.baddbmm(self.bias, x, self.weight.transpose(1, 2))
        # flax's order: the product rounded to `cd`, then the bias added
        return torch.bmm(x, self.weight.to(cd).transpose(1, 2)) \
            + self.bias.to(cd)


class _MemberStack(nn.Module):
    """What the stacked populations share: a stack built from given
    networks, and one member copied out of it."""

    @classmethod
    def from_members(cls, members):
        """Copies of `members` (networks of one shape) as one stack."""
        net = cls.__new__(cls)
        nn.Module.__init__(net)
        net._stack(list(members))
        return net

    def _member_into(self, net: nn.Module, k: int) -> nn.Module:
        """`net` (a fresh member-shaped network) loaded with member k's
        parameters, on this module's device."""
        net.load_state_dict({name: p[k].reshape(net.get_parameter(
            name).shape) for name, p in self.named_parameters()})
        return net.to(self.log_std.device)


class PopulationActorCritic(_MemberStack):
    """K `ActorCritic`s of one shape, stacked on a leading member axis.

    forward(obs (K, M, obs_dim)) -> (mean (K, M, action_dim), log_std
    (K, 1, action_dim), value (K, M)): member k's outputs are what its own
    `ActorCritic` gives on obs[k].  Parameters and `state_dict` keys are
    `ActorCritic`'s with a leading K axis (biases (K, 1, out)).
    `generators` (one per member) seed the members' orthogonal inits:
    member k is the `ActorCritic` that generators[k] would give.
    `from_members` stacks given networks, `member(k)` copies one out.
    """

    def __init__(self, num_members: int, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 log_std_init: float = 0.0, compute_dtype=None,
                 generators: Sequence[torch.Generator] | None = None):
        super().__init__()
        if generators is None:
            generators = [None] * num_members
        if len(generators) != num_members:
            raise ValueError(f"{len(generators)} generators for "
                             f"{num_members} members")
        self._stack([ActorCritic(obs_dim, action_dim, hidden, log_std_init,
                                 compute_dtype, generator=g)
                     for g in generators])

    def _stack(self, members):
        m0 = members[0]
        shape = (m0.obs_dim, m0.action_dim, m0.hidden, m0.compute_dtype)
        if any((m.obs_dim, m.action_dim, m.hidden, m.compute_dtype) != shape
               for m in members):
            raise ValueError("the members differ in shape or compute_dtype")
        self.num_members = len(members)
        self.obs_dim, self.action_dim, self.hidden, self.compute_dtype = shape
        self.log_std_init = m0.log_std_init
        self.pi = nn.ModuleList(_StackedLinear([m.pi[i] for m in members])
                                for i in range(len(m0.hidden)))
        self.mean = _StackedLinear([m.mean for m in members])
        self.vf = nn.ModuleList(_StackedLinear([m.vf[i] for m in members])
                                for i in range(len(m0.hidden)))
        self.value = _StackedLinear([m.value for m in members])
        self.log_std = nn.Parameter(torch.stack(
            [m.log_std.detach() for m in members]).clone())

    def member(self, k: int) -> ActorCritic:
        """A copy of member k as an `ActorCritic`, on this module's
        device."""
        return self._member_into(ActorCritic(
            self.obs_dim, self.action_dim, self.hidden, self.log_std_init,
            self.compute_dtype, generator=torch.Generator()), k)

    def forward(self, obs: torch.Tensor):
        cd = self.compute_dtype
        x = v = obs if cd is None else obs.to(cd)
        for layer in self.pi:
            x = torch.tanh(layer(x, cd))
        for layer in self.vf:
            v = torch.tanh(layer(v, cd))
        mean, value = self.mean(x, cd), self.value(v, cd)
        if cd is not None:
            mean, value = mean.float(), value.float()
        return mean, self.log_std[:, None, :], value.squeeze(-1)


def gaussian_log_prob(mean, log_std, action):
    """Diagonal-Gaussian log pdf summed over the action dimension."""
    var = torch.exp(2 * log_std)
    return torch.sum(
        -0.5 * ((action - mean) ** 2 / var + 2 * log_std
                + math.log(2 * math.pi)), dim=-1)


def gaussian_entropy(log_std):
    """Entropy of the diagonal Gaussian (state-independent)."""
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
