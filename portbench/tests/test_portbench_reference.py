"""The plain reference against the port's CPU path at a tiny size: the
env step of both configurations (the port's plain versions, which its
kernels are held to), and three PPO updates of the port's trainer."""
import json

import pytest
import torch

from portbench import port
from portbench.reference import ref_env


def config(name):
    with open(f"portbench/configs/{name}.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name,steps", [("hover_dyn", 16),
                                        ("routing4_pyb", 2)])
def test_env_step_matches_port(name, steps):
    from gym_pybullet_drones_tpu_torch.envs.fast import (
        fused_spec, make_fused_rollout)
    from gym_pybullet_drones_tpu_torch.ops import kernel_fused
    c = config(name)
    cfg, task = port.build(c)
    env = ref_env.make(c)
    spec = fused_spec(cfg, task)
    assert spec.init16 == env.init16
    assert (spec.carry_rows, spec.out_rows) == (env.carry_rows,
                                                env.out_rows)
    b = 8
    reset, _ = make_fused_rollout(cfg, task, b, obs_layout="rows",
                                  device="cpu")
    carry, obs = reset()
    r_carry, r_obs = env.reset(b, "cpu")
    assert torch.equal(carry, r_carry) and torch.equal(obs, r_obs)
    gen = torch.Generator().manual_seed(4)
    for _ in range(steps):
        a = 0.5 * torch.randn((env.n * env.act_dim, b), generator=gen)
        carry, outs = kernel_fused.fused_env_step_plain(spec, carry, a)
        r_carry, r_outs = env.step(r_carry, a)
        assert torch.equal(carry, r_carry) and torch.equal(outs, r_outs)


def test_ppo_updates_match_port():
    from portbench import cell as cells
    from portbench.drivers import train
    cell = cells.load("hover_dyn.train8192")
    cell.traffic.update(num_envs=32, rollout_steps=8)
    prog = train.train_loop(None, cell, 9, 0.0, False, "cpu", 0.0)
    numbers = train.verify(cell, 9, train.as_tensors(prog["check"]), "cpu")
    # the same float32 arithmetic in another order: round-off only
    assert max(numbers.values()) < 1e-5, numbers
