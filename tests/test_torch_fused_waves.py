"""The fused env step's waves (`ops/kernel_fused.launch_waves`): the
attribute `waves` of the wrapper's `kernel.fused_env_step` span, and the
benchmark's reader of it (`portbench/metrics/fused_env_step_waves.rollout.py`)
on a hand-made ctx.  On the host the wrapper runs the plain version and
its span carries no `waves`.  On a card the kernel's occupancy query
(`_build.resident_blocks`), the routing fleet's launch at 16384 fleets of
4 in one wave, and 33 of those fleets launched alone against the same
columns of that launch bit for bit; those tests need CUDA and skip
elsewhere (`card`).  The file imports no JAX, so on a machine without it
run it as `python -m pytest --noconftest tests/test_torch_fused_waves.py
-q`."""
import pytest
import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.envs import fast, make_routing_config
from gym_pybullet_drones_tpu_torch.ops import kernel_fused
from gym_pybullet_drones_tpu_torch.utils import profiling
from portbench import cell as cells
from portbench import program

READER = "fused_env_step_waves.rollout"
SPAN = "kernel.fused_env_step"
FLEETS = 16384       # the routing cell's batch
SUBSET = 33          # fleets of the second launch: a full block and one


@pytest.fixture
def card():
    """A CUDA card; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel and its occupancy exist "
                    "only there")
    return torch.device("cuda")


def spans_ctx(attrs, count=512):
    return {program.DONE: True, "program_spans": {SPAN: {
        "count": count, "total_s": 0.05, "self_s": 0.05, "attrs": attrs}}}


@pytest.mark.parametrize("ctx, want", [
    (spans_ctx({"waves": 0.97 * 512}), 0.97),
    (spans_ctx({"waves": 1.94 * 8}, count=8), 1.94),
    (spans_ctx({}), None),
    ({program.DONE: True}, None),
], ids=["one_wave", "two_waves", "no_attribute", "no_span"])
def test_reader_on_a_hand_made_ctx(ctx, want):
    got = cells.reader(READER)(ctx)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def routing_step(b, device, steps=3, seed=0):
    """The routing fleet of 4 on PYB through `make_fused_rollout` on
    `device`: the spec, the carry after `steps` random waypoint steps from
    the reset, and the action rows of one more step."""
    cfg, task = make_routing_config(num_drones=4)
    reset, step = fast.make_fused_rollout(cfg, task, b, obs_layout="flat",
                                          device=device)
    gen = torch.Generator(device).manual_seed(seed)
    shape = (b, cfg.num_drones, task.action_dim(cfg))
    carry, _ = reset()
    for _ in range(steps):
        carry = step(carry, 0.1 * torch.randn(shape, generator=gen,
                                              device=device))[0]
    a_rows = 0.1 * torch.randn(shape, generator=gen, device=device)
    a_rows = a_rows.reshape(b, -1).t().contiguous()
    return fast.fused_spec(cfg, task), carry, a_rows


def test_cpu_span_carries_no_waves():
    spec, carry, a_rows = routing_step(2, "cpu", steps=0)
    with profiling.recording() as record:
        kernel_fused.fused_env_step(spec, carry, a_rows)
    got = record.summary()[SPAN]
    assert got["count"] == 1 and "waves" not in got["attrs"]


def test_occupancy_holds_four_fleet_blocks_an_sm(card):
    # 128 threads a block of 4 drones at <= 128 registers: 4 blocks, 16
    # warps, an SM of sm_90
    assert _build.resident_blocks("fused_env_step", 4, True) >= 4


def test_routing_cell_launch_in_one_wave(card):
    spec, carry, a_rows = routing_step(FLEETS, card)
    assert kernel_fused.launch_waves(FLEETS, 4, True, carry.device) <= 1.0
    with profiling.recording() as record:
        got = kernel_fused.fused_env_step(spec, carry, a_rows)
    rec = record.summary()[SPAN]
    assert rec["count"] == 1 and rec["attrs"]["waves"] <= 1.0
    # an env's threads compute the same wherever its block lies
    cols = torch.arange(SUBSET, device=card) * (FLEETS // SUBSET)
    alone = kernel_fused.fused_env_step(spec, carry[:, cols].contiguous(),
                                        a_rows[:, cols].contiguous())
    torch.cuda.synchronize()
    for whole, part in zip(got, alone):
        assert torch.equal(whole[:, cols].view(torch.int32),
                           part.view(torch.int32))
