"""The frozen work counts against hand counts for one env."""
import json

import pytest

from portbench.counts import work


def config(name):
    with open(f"portbench/configs/{name}.json") as f:
        return json.load(f)


def test_hover_env_step_by_hand():
    # one drone, 8 DYN substeps: mixer 30 + 8 x 175 + 2 Euler x 40 + task 40
    ops, nbytes = work.env_step_work(config("hover_dyn"))
    assert ops == 30 + 8 * 175 + 2 * 40 + 40 == 1550
    # read: 13 state rows + the ring's 60 rows less the 4 it drops, the
    # counter, 4 action rows; written: the carry (16 + 4 + 60 + 1) and the
    # outputs (12 + 60 obs rows, reward, terminated, truncated)
    assert nbytes == 4 * ((13 + 60 - 4) + 1 + 4 + 81 + 75) == 920
    # bytes bound the step: 920 B x 4096 envs at 3.35 TB/s
    assert work.bound_s(ops * 4096, nbytes * 4096) == pytest.approx(
        920 * 4096 / 3.35e12)


def test_routing_env_step_by_hand():
    ops, nbytes = work.env_step_work(config("routing4_pyb"))
    n, sub, sweeps = 4, 8, 4
    per_drone_substep = 44 + 55 + 85 + 364 + 53 + sweeps * 532
    pyb = sub * (n * per_drone_substep + 523 * 6 + 56 * n) \
        + n * (40 + 40)
    column = n * (30 + 175 * sub + 2 * 40 + 40 + 325 + 20) \
        + 9 * 12 // 2 + 10 * 12
    assert ops == column + pyb - n * (175 * sub + 30 + 40 + 40) == 116258
    # read 16 state + 9 PID + 45 ring - 3 dropped a drone, the counter and
    # 12 action rows; written the carry (4 x 74 + 1) and the outputs
    assert nbytes == 4 * (4 * (16 + 9 + 45 - 3) + 1 + 12 + 297 + 255)


def test_policy_flops_by_hand():
    fwd, fwd_bwd = work.policy_flops(config("hover_dyn"))
    macs = 72 * 64 + 64 * 64
    heads = 2 * 64 * (4 + 1)
    assert fwd == 2 * (2 * macs + 2 * 128) + heads + 5
    assert fwd_bwd == fwd + 2 * (4 * macs + heads)
    # one update of 8192 envs x 64 steps, 4 epochs
    per = fwd + 4 * fwd_bwd + 1550
    assert work.update_flops(config("hover_dyn"), 8192, 64) \
        == 8192 * 64 * per
