"""The plain reference of a PPO update: rollout, GAE, the clipped loss,
the gradient, clipping by the global norm and Adam, in float32 plain
PyTorch with TF32 off.

It follows the published algorithm as stable-baselines3 and the JAX
package chain it (optax `clip_by_global_norm` then `adam(eps=1e-5)` with
eps outside the square root; advantages normalised per minibatch with
the ddof-0 std; time-axis minibatches, each of `rollout_steps /
num_minibatches` whole control steps of every env), over the plain
environment of `ref_env`.  The policy is the SB3 MlpPolicy: separate
tanh towers for the Gaussian mean and the value, a state-independent
log-std.  Weights and random draws come from the benchmark, never from
the program.
"""
from __future__ import annotations

import math

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-5


def param_names(num_hidden: int) -> list:
    """The policy's parameter names, in the order the benchmark makes
    them."""
    names = []
    for tower in ("pi", "vf"):
        for i in range(num_hidden):
            names += [f"{tower}.{i}.weight", f"{tower}.{i}.bias"]
        head = "mean" if tower == "pi" else "value"
        names += [f"{head}.weight", f"{head}.bias"]
    return names + ["log_std"]


def forward(p: dict, obs: torch.Tensor, num_hidden: int):
    """(mean, log_std, value) of the actor-critic with parameters `p` on
    obs (M, D)."""
    x = v = obs
    for i in range(num_hidden):
        x = torch.tanh(x @ p[f"pi.{i}.weight"].t() + p[f"pi.{i}.bias"])
        v = torch.tanh(v @ p[f"vf.{i}.weight"].t() + p[f"vf.{i}.bias"])
    mean = x @ p["mean.weight"].t() + p["mean.bias"]
    value = v @ p["value.weight"].t() + p["value.bias"]
    return mean, p["log_std"], value[..., 0]


def log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def entropy(log_std):
    return (0.5 + 0.5 * math.log(2 * math.pi) + log_std).sum(-1)


class RefTrainer:
    """PPO on `env` (a `ref_env.RefEnv`) from the weights `params` (a dict
    of tensors by `param_names`), stepping `num_envs` envs.

    `update(draws)` runs one update with the draws `(noise (T, E, A),
    perms (epochs, T))` and returns its metrics; `mu` holds Adam's first
    moments, `params` the weights.  `drop_half` leaves half of the envs
    out of every minibatch: a fault the calibration reads."""

    def __init__(self, env, ppo: dict, params: dict, num_envs: int,
                 num_hidden: int, device, drop_half=False):
        self.env, self.ppo, self.e = env, ppo, num_envs
        self.num_hidden, self.drop_half = num_hidden, drop_half
        self.params = {k: v.detach().clone().float().to(device)
                       for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.count = 0
        self.dones = []           # each rollout step's done flags
        self.carry, obs_rows = env.reset(num_envs, device)
        self.obs = obs_rows.t()

    @classmethod
    def from_state(cls, env, ppo: dict, state: dict, num_hidden: int,
                   device, drop_half=False):
        """A trainer that resumes from a state: `params`, Adam's `mu`,
        `nu` (dicts by name) and `count`, the env `carry` (RC, E) and the
        observations `obs` (E, D)."""
        carry = state["carry"].to(device)
        self = cls(env, ppo, state["params"], carry.shape[1], num_hidden,
                   device, drop_half)
        self.mu = {k: state["mu"][k].clone().to(device) for k in self.params}
        self.nu = {k: state["nu"][k].clone().to(device) for k in self.params}
        self.count = int(state["count"])
        self.carry = carry.clone()
        self.obs = state["obs"].to(device).clone()
        return self

    def net(self, obs):
        return forward(self.params, obs, self.num_hidden)

    def rollout(self, noise):
        n, a = self.env.n, self.env.act_dim
        ro = n * self.env.obs_rows_per
        steps = []
        with torch.no_grad():
            for t in range(noise.shape[0]):
                mean, log_std, value = self.net(self.obs)
                action = mean + torch.exp(log_std) * noise[t]
                lp = log_prob(mean, log_std, action)
                self.carry, outs = self.env.step(
                    self.carry, action.reshape(self.e, n * a).t()
                    .contiguous())
                done = ((outs[ro + 1] > 0.5) | (outs[ro + 2] > 0.5)).float()
                self.dones.append(done)
                steps.append((self.obs, action, lp, value, outs[ro], done))
                self.obs = outs[:ro].t()
            last_value = self.net(self.obs)[2]
        return [torch.stack(x) for x in zip(*steps)], last_value

    def gae(self, value, reward, done, last_value):
        gamma, lam = self.ppo["gamma"], self.ppo["gae_lambda"]
        nonterminal = 1.0 - done
        next_value = torch.cat([value[1:], last_value[None]])
        delta = reward + gamma * next_value * nonterminal - value
        adv = torch.zeros_like(last_value)
        out = [None] * len(delta)
        for t in reversed(range(len(delta))):
            adv = delta[t] + gamma * lam * nonterminal[t] * adv
            out[t] = adv
        adv = torch.stack(out)
        return adv, adv + value

    def loss(self, obs, action, old_lp, adv, ret):
        ppo = self.ppo
        mean, log_std, value = self.net(obs)
        ratio = torch.exp(log_prob(mean, log_std, action) - old_lp)
        with torch.no_grad():
            a_mean = adv.mean()
            a_std = torch.sqrt(torch.square(adv - a_mean).mean())
        norm = (adv - a_mean) / (a_std + 1e-8)
        pg = -torch.minimum(ratio * norm, torch.clamp(
            ratio, 1 - ppo["clip_eps"], 1 + ppo["clip_eps"]) * norm).mean()
        v = 0.5 * torch.square(value - ret).mean()
        ent = entropy(log_std)
        return pg + ppo["vf_coef"] * v - ppo["ent_coef"] * ent, (pg, v, ent)

    def adam(self, grads):
        ppo = self.ppo
        limit = ppo["max_grad_norm"]
        norm = torch.sqrt(sum(torch.square(g).sum() for g in grads.values()))
        self.count += 1
        c1, c2 = 1 - ADAM_B1 ** self.count, 1 - ADAM_B2 ** self.count
        for k, g in grads.items():
            g = torch.where(norm < limit, g, g / norm * limit)
            self.mu[k] = ADAM_B1 * self.mu[k] + (1 - ADAM_B1) * g
            self.nu[k] = ADAM_B2 * self.nu[k] + (1 - ADAM_B2) * g * g
            step = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2)
                                        + ADAM_EPS)
            self.params[k] = self.params[k] - ppo["lr"] * step

    def update(self, noise, perms) -> dict:
        (obs, action, lp, value, reward, done), last_value = \
            self.rollout(noise)
        adv, ret = self.gae(value, reward, done, last_value)
        t = obs.shape[0]
        mb = t // self.ppo["num_minibatches"]
        keep = slice(0, self.e // 2) if self.drop_half else slice(None)
        flat = lambda x, take: x[take][:, keep].transpose(0, 1) \
            .reshape((-1,) + x.shape[2:])
        terms = []
        for epoch in range(perms.shape[0]):
            for i in range(self.ppo["num_minibatches"]):
                take = perms[epoch, i * mb:(i + 1) * mb]
                for p in self.params.values():
                    p.requires_grad_(True)
                total, aux = self.loss(flat(obs, take), flat(action, take),
                                       flat(lp, take), flat(adv, take),
                                       flat(ret, take))
                grads = torch.autograd.grad(total, list(self.params.values()))
                for p in self.params.values():
                    p.requires_grad_(False)
                self.params = {k: v.detach() for k, v in self.params.items()}
                self.adam(dict(zip(self.params, grads)))
                terms.append(torch.stack([x.detach() for x in aux]))
        pg, v, ent = torch.stack(terms).mean(dim=0).tolist()
        return {"mean_reward": float(reward.mean()),
                "mean_value": float(value.mean()),
                "pg_loss": pg, "v_loss": v, "entropy": ent}
