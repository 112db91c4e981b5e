"""Checkpoint/resume of the port's trainer (gym_pybullet_drones_tpu_torch/
utils/checkpoint.py), on the CPU: tests/test_checkpoint.py:17's
configuration (Hover, DYN, RPM, 4 envs x 8 steps, 2 minibatches, 1 epoch).

As there: one update, a save, a restore into a fresh learner, then one
more update from the original and one from the restored state, which must
agree bit for bit (weights, Adam's moments, the env carry, the metrics).
Here the restored state is a second TrainState (its own module, moments
and generator), so the two continuations cannot share a tensor; the file
loads with `weights_only=True`.  Both env paths: the fused carry, and the
batched path's `EnvState` with its nested PID carry; and the batched path
of a task with reset noise, whose stream (`TrainState.reset_noise`) is
saved and restored, with an evaluation (a reset of the same env) between
the save and the two continuations."""
import dataclasses

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu_torch.envs.core import leaves
from gym_pybullet_drones_tpu_torch.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics


def _leaves(ts):
    noise = [] if ts.reset_noise is None else [
        ts.reset_noise.generator.get_state(), ts.reset_noise.block]
    return (list(ts.network.state_dict().values()) + list(ts.opt_state.mu)
            + list(ts.opt_state.nu) + leaves(ts.env_state) + [ts.last_obs]
            + noise)


def _assert_same(a, b):
    assert a.opt_state.count == b.opt_state.count
    assert a.update_idx == b.update_idx
    assert (a.reset_noise is None) == (b.reset_noise is None)
    if a.reset_noise is not None:
        assert a.reset_noise is not b.reset_noise
        assert a.reset_noise.index == b.reset_noise.index
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y.numpy())


@pytest.mark.parametrize("env_path", ["fused", "batched", "batched_noise"])
def test_checkpoint_roundtrip_resume(tmp_path, env_path):
    cfg = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
    task = HoverTask(act=ActionType.RPM)
    if env_path == "batched_noise":
        # short episodes, so that envs end and take noisy resets inside
        # each update
        task = dataclasses.replace(task, reset_pos_noise=0.2,
                                   reset_rpy_noise=0.1, episode_len_sec=0.2)
        env_path = "batched"
    ppo = PPOConfig(num_envs=4, rollout_steps=8, num_minibatches=2,
                    update_epochs=1)
    init, update, evaluate, _ = make_train(cfg, task, ppo, device="cpu",
                                           env_path=env_path)
    assert update.env_path == env_path
    ts = init(torch.Generator().manual_seed(0))
    ts, _ = update(ts)
    index = None if ts.reset_noise is None else ts.reset_noise.index

    path = save_checkpoint(str(tmp_path / "ckpt"), ts, step=1)
    assert path.endswith("step_1.pt")
    torch.load(path, weights_only=True)        # plain types only
    restored = restore_checkpoint(path, init(torch.Generator().manual_seed(1)))
    _assert_same(ts, restored)
    assert restored.network is not ts.network
    assert torch.equal(restored.generator.get_state(),
                       ts.generator.get_state())

    # an evaluation resets the env; it moves neither run's stream
    evaluate(ts.network, num_steps=2)
    if index is not None:
        assert ts.reset_noise.index == index > 1

    # continuing from the original and from the restored state: identical
    a1, m1 = update(ts)
    a2, m2 = update(restored)
    _assert_same(a1, a2)
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k


def test_restore_refuses_another_run(tmp_path):
    """A checkpoint restored into a learner of another batch size fails
    loudly instead of mixing carries."""
    cfg = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
    task = HoverTask(act=ActionType.RPM)
    make = lambda e: make_train(cfg, task, PPOConfig(
        num_envs=e, rollout_steps=8, num_minibatches=2, update_epochs=1),
        device="cpu")[0](torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path / "ckpt.pt"), make(4))
    with pytest.raises(ValueError, match="env carry"):
        restore_checkpoint(path, make(8))
