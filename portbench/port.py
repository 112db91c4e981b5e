"""The system under test: `gym_pybullet_drones_tpu_torch`, built from a
configuration file.

Only this module and the drivers import the port.  `build(config)` returns
the port's (AviaryConfig, task) for the file's env, and `ppo_config`
its PPOConfig for a traffic mix's batch.  The drone's constants in the
file are held against the port's own CF2X, so that a program whose
drone drifts from the configuration is refused before any run.
"""
from __future__ import annotations

import dataclasses


def build(config: dict):
    """(AviaryConfig, task) of the port for `config["env"]`."""
    from gym_pybullet_drones_tpu_torch.envs.core import AviaryConfig
    from gym_pybullet_drones_tpu_torch.envs.routing import RoutingTask
    from gym_pybullet_drones_tpu_torch.envs.tasks import HoverTask
    from gym_pybullet_drones_tpu_torch.params import CF2X
    from gym_pybullet_drones_tpu_torch.utils.enums import (
        ActionType, ObservationType, Physics)

    want = dict(config["drone"])
    have = dataclasses.asdict(CF2X)
    have["model"] = CF2X.model.value
    have["prop_offsets"] = [list(p) for p in CF2X.prop_offsets]
    if want != have:
        raise ValueError(f"the port's CF2X {have} is not the "
                         f"configuration's drone {want}")
    env = config["env"]
    init = env.get("init_xyzs")
    cfg = AviaryConfig(
        drone=CF2X, num_drones=int(env["num_drones"]),
        physics=Physics(env["physics"]), pyb_freq=int(env["pyb_freq"]),
        ctrl_freq=int(env["ctrl_freq"]),
        init_xyzs=None if init is None else tuple(tuple(p) for p in init),
        solver_iterations=int(env.get("solver_iterations", 4)))
    t = dict(env["task"])
    kind = t.pop("kind")
    t["act"] = ActionType(t["act"])
    t["obs"] = ObservationType(t["obs"])
    if kind == "hover":
        task = HoverTask(target_pos=tuple(t.pop("target_pos")), **t)
    elif kind == "routing":
        cfg = dataclasses.replace(cfg, neighbourhood_radius=1.0)
        task = RoutingTask(destinations=tuple(
            tuple(p) for p in t.pop("destinations")), **t)
    else:
        raise ValueError(f"unknown task kind {kind!r}")
    return cfg, task


def ppo_config(config: dict, num_envs: int, rollout_steps: int,
               compute_dtype=None):
    """The port's PPOConfig of the configuration's policy and PPO settings
    at a traffic mix's batch."""
    from gym_pybullet_drones_tpu_torch.rl.ppo import PPOConfig
    ppo = dict(config["ppo"])
    return PPOConfig(num_envs=num_envs, rollout_steps=rollout_steps,
                     hidden=tuple(config["policy"]["hidden"]),
                     compute_dtype=compute_dtype, **ppo)
