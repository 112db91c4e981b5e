"""State carried across from the JAX package, as numpy arrays.

Both packages can be started from the same mid-rollout state: the JAX
side's `EnvState` leaves and packed fused carry are handed over as numpy
arrays and become this package's tensors, and back.  Nothing here imports
the JAX package; the caller does the `np.asarray`.

`env_state_from_fused_carry` turns the port's own opaque fused carry into
the batched path's flat EnvState.  `actor_critic_state_dict_from_flax`
carries the JAX package's actor-critic params into `models.ActorCritic`,
`population_state_dict_from_flax` a population's (the same params with a
leading member axis) into `models.PopulationActorCritic`, and
`actor_critic_cnn_state_dict_from_flax` its NatureCNN's into
`models.ActorCriticCNN`, `population_cnn_state_dict_from_flax` a
population of them into `models.PopulationActorCriticCNN`.
"""
from __future__ import annotations

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch.control.dsl_pid import PIDState
from gym_pybullet_drones_tpu_torch.envs.core import EnvState
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device

LANE = 128  # the JAX package pads the fused carry's env axis to this


def env_state_from_numpy(leaves: dict, device=None) -> EnvState:
    """JAX `EnvState` leaves {field: array} -> this package's EnvState.

    Shapes are kept (per-env (N, k), batched, or the flat (B*N, k) carry).
    `ctrl_state`, the embedded-PID carry, is a {field: array} dict of the
    JAX `PIDState`'s leaves (or the NamedTuple itself); where it is left
    out, the controllers start from zero.  The JAX-only `rng` leaf is
    ignored.  Float leaves keep their dtype, the step counter becomes
    int32.
    """
    device = resolve_device(device)
    conv = lambda x: torch.tensor(np.asarray(x), device=device)
    fields = {k: conv(leaves[k]) for k in EnvState._fields
              if k not in ("step_counter", "ctrl_state")}
    pid = leaves.get("ctrl_state")
    if pid is None:
        ctrl_state = PIDState(*(torch.zeros_like(fields["pos"])
                                for _ in PIDState._fields))
    else:
        pid = pid if isinstance(pid, dict) else pid._asdict()
        ctrl_state = PIDState(**{k: conv(pid[k]) for k in PIDState._fields})
    return EnvState(
        step_counter=conv(leaves["step_counter"]).to(torch.int32),
        ctrl_state=ctrl_state, **fields)


def env_state_to_numpy(state: EnvState) -> dict:
    """This package's EnvState -> {field: numpy array}, `ctrl_state` as a
    nested {field: array} dict."""
    to_np = lambda v: v.detach().cpu().numpy()
    out = {k: to_np(v) for k, v in state._asdict().items()
           if k != "ctrl_state"}
    out["ctrl_state"] = {k: to_np(v)
                         for k, v in state.ctrl_state._asdict().items()}
    return out


def env_state_from_fused_carry(carry: torch.Tensor, num_drones: int,
                               act) -> EnvState:
    """This package's packed fused carry (RC, B) -> the flat (B*N, k)
    EnvState that `envs.fast.make_batched_step` carries, on the same
    device: the opaque rollout carry made inspectable, or continued on the
    batched path.  `act` is the task's ActionType (the PID family
    carries 9 more rows per drone)."""
    from gym_pybullet_drones_tpu_torch.ops import kernel_fused
    per = (carry.shape[0] - 1) // num_drones
    buf_rows = per - kernel_fused._layout(1, 0, act)[0]
    lv = kernel_fused.unpack_carry(carry, num_drones, buf_rows, act)
    pid = lv.get("pid")
    if pid is None:
        pid = torch.zeros((lv["pos"].shape[0], 9), dtype=carry.dtype,
                          device=carry.device)
    return EnvState(
        pos=lv["pos"], quat=lv["quat"], vel=lv["vel"],
        rpy_rates=lv["rpy_rates"], ang_v=lv["ang_v"],
        last_rpm=lv["last_rpm"], action_buffer=lv["action_buffer"],
        ctrl_state=PIDState(pid[:, 0:3], pid[:, 3:6], pid[:, 6:9]),
        step_counter=lv["step_counter"].round().to(torch.int32))


def fused_carry_from_numpy(carry: np.ndarray, num_envs: int,
                           device=None) -> torch.Tensor:
    """JAX packed fused carry (RC, Bp), Bp = num_envs padded to 128 lanes
    -> this package's (RC, num_envs) float32 carry (padding dropped)."""
    device = resolve_device(device)
    return torch.tensor(np.asarray(carry, np.float32)[:, :num_envs],
                        device=device)


def fused_carry_to_numpy(carry: torch.Tensor) -> np.ndarray:
    """This package's (RC, B) carry -> the JAX package's (RC, Bp) numpy
    block, env axis zero-padded to a multiple of 128 lanes."""
    blk = carry.detach().cpu().numpy()
    pad = (-blk.shape[1]) % LANE
    return np.pad(blk, ((0, 0), (0, pad)))


def actor_critic_state_dict_from_flax(params) -> dict:
    """The JAX package's `ActorCritic` params as numpy arrays -> the
    `state_dict` of this package's `models.ActorCritic` (float32, CPU).

    `params` is what `network.init` returns (`{"params": {...}}`), its
    inner dict, or a `best_model.pkl` that the JAX `examples/learn.py`
    pickled.  Flax numbers the Dense layers in call order: with L hidden
    layers a tower, `Dense_0` .. `Dense_{L-1}` are the pi tower and
    `Dense_L` the mean head, `Dense_{L+1}` .. `Dense_{2L}` the vf tower and
    `Dense_{2L+1}` the value head.  A flax kernel is (in, out), a torch
    weight (out, in).  Every leaf becomes float32: under x64 the JAX
    `log_std` is float64.
    """
    p = params.get("params", params)
    dense = sorted((k for k in p if k.startswith("Dense_")),
                   key=lambda k: int(k.split("_")[1]))
    if len(dense) % 2 or len(dense) < 2 or "log_std" not in p:
        raise ValueError(f"not an ActorCritic params tree: {sorted(p)}")
    n_hidden = len(dense) // 2 - 1
    names = ([f"pi.{i}" for i in range(n_hidden)] + ["mean"]
             + [f"vf.{i}" for i in range(n_hidden)] + ["value"])
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    out = {}
    for name, key in zip(names, dense):
        out[f"{name}.weight"] = f32(np.asarray(p[key]["kernel"]).T)
        out[f"{name}.bias"] = f32(p[key]["bias"])
    out["log_std"] = f32(p["log_std"])
    return out


def population_state_dict_from_flax(params) -> dict:
    """The JAX package's population params (every `ActorCritic` leaf with
    a leading (K,) member axis, as `make_train_population`'s init stacks
    them) as numpy arrays -> the `state_dict` of this package's
    `models.PopulationActorCritic` (float32, CPU): each member carried
    across by `actor_critic_state_dict_from_flax`, then stacked; biases
    become (K, 1, out)."""
    stacked = _stack_members(params, actor_critic_state_dict_from_flax)
    return {name: x[:, None, :] if name.endswith(".bias") else x
            for name, x in stacked.items()}


def _stack_members(params, convert_member) -> dict:
    """Every leaf of a population's flax params carries a leading (K,)
    member axis: each member carried across by `convert_member`, then
    stacked along a new leading axis."""
    p = params.get("params", params)
    if np.ndim(p.get("log_std")) != 2:
        raise ValueError("not a population's params: log_std must be (K, "
                         "action_dim)")
    member = lambda i: {
        name: {leaf: np.asarray(v)[i] for leaf, v in layer.items()}
        if isinstance(layer, dict) else np.asarray(layer)[i]
        for name, layer in p.items()}
    members = [convert_member(member(i)) for i in range(len(p["log_std"]))]
    return {name: torch.stack([m[name] for m in members])
            for name in members[0]}


def actor_critic_cnn_state_dict_from_flax(params) -> dict:
    """The JAX package's `ActorCriticCNN` params as numpy arrays -> the
    `state_dict` of this package's `models.ActorCriticCNN` (float32, CPU).

    Flax names the layers in call order: `Conv_0` .. `Conv_2` the trunk,
    `Dense_0` the 512-wide layer, `Dense_1` the mean head, `Dense_2` the
    value head.  A flax conv kernel is HWIO, a torch weight OIHW.  Both
    modules flatten the last feature map in (h, w, c) order, so `Dense_0`
    carries across as a plain transpose, like the heads.
    """
    p = params.get("params", params)
    if sorted(k for k in p if k.startswith(("Conv_", "Dense_"))) != [
            "Conv_0", "Conv_1", "Conv_2", "Dense_0", "Dense_1", "Dense_2"] \
            or "log_std" not in p:
        raise ValueError(f"not an ActorCriticCNN params tree: {sorted(p)}")
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    out = {}
    for i in range(3):
        kernel = np.asarray(p[f"Conv_{i}"]["kernel"])
        out[f"convs.{i}.weight"] = f32(kernel.transpose(3, 2, 0, 1))
        out[f"convs.{i}.bias"] = f32(p[f"Conv_{i}"]["bias"])
    for name, key in (("dense", "Dense_0"), ("mean", "Dense_1"),
                      ("value", "Dense_2")):
        out[f"{name}.weight"] = f32(np.asarray(p[key]["kernel"]).T)
        out[f"{name}.bias"] = f32(p[key]["bias"])
    out["log_std"] = f32(p["log_std"])
    return out


def population_cnn_state_dict_from_flax(params) -> dict:
    """The JAX package's population of `ActorCriticCNN`s (every leaf with a
    leading (K,) member axis, as `make_train_population`'s init stacks
    them for an RGB task) as numpy arrays -> the `state_dict` of this
    package's `models.PopulationActorCriticCNN` (float32, CPU): each
    member carried across by `actor_critic_cnn_state_dict_from_flax`, then
    stacked; conv weights become (K, out, in, kh, kw), conv biases (K,
    out), dense biases (K, 1, out)."""
    stacked = _stack_members(params, actor_critic_cnn_state_dict_from_flax)
    return {name: x[:, None, :] if name.endswith(".bias")
            and not name.startswith("convs.") else x
            for name, x in stacked.items()}
