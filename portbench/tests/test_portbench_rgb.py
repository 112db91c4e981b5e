"""The pixel training cell `hover_rgb.ppo512` on the CPU: the cell found by
its name, the work counts against hand counts, a run of
`drivers/train_rgb.py` at a tiny size through `correct` (traced and
untraced), and the control and each fault of the calibration
(`portbench/calibrate_rgb.py`) failing `correct`.  At 4 envs x 4 steps (one control step a minibatch) the
program and the reference run the port's plain versions and the plain
reference on CPU tensors."""
import json
import time

import pytest
import torch

from portbench import calibrate_rgb, cell as cells, run
from portbench.counts import pixels

WORKLOAD = "hover_rgb.ppo512"
TINY = {"num_envs": 4, "rollout_steps": 4, "check_rows": 4,
        "trace_updates": 1}
SEED = 2 ** 31 + 11
NEW = ("render_roofline", "dyn_ctrl_step_roofline",
       "batched_step_launches.rgb", "batched_step_host_ms.rgb",
       "mfu.train_rgb")


@pytest.fixture(autouse=True)
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny():
    cell = cells.load(WORKLOAD)
    cell.traffic.update(TINY)
    return cell


def config():
    with open("portbench/configs/hover_rgb.json") as f:
        return json.load(f)


def test_cell_loads_by_name():
    cell = cells.load(WORKLOAD)
    assert cell.chips == 1 and cell.traffic["driver"] == "train_rgb"
    assert {m["name"] for m in cell.end_to_end} == {
        "train_env_steps_per_s", "update_ms_p95", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap",
                                "policy_gap", "image_err",
                                "image_tie_share"}
    assert all(v.get("limit") is not None for v in cell.limits.values())
    assert cell.config["reduced"] == []


def test_counts_by_hand():
    c = config()
    assert pixels.cnn_layer_flops(c) == {
        "conv1": 2_703_360,     # 11 x 15 x 32 outputs x 8 x 8 x 4 MACs
        "conv2": 1_572_864,     # 4 x 6 x 64 x 4 x 4 x 32
        "conv3": 589_824,       # 2 x 4 x 64 x 3 x 3 x 64
        "dense": 524_288,       # 512 x 512
        "heads": 2_048}         # 512 x (1 action + 1 value)
    fwd, fwd_bwd = pixels.cnn_flops(c)
    assert fwd == 5_392_384 and fwd_bwd == 3 * fwd
    # the port's kernel table: render at 512 cameras, K1 at B = 512
    assert 1e3 * pixels.render_bound_s(512, c) == 0.00985974447761194
    assert 1e3 * pixels.k1_bound_s(512, c) == 0.000020174328358208954
    # the render is bound by its operations, K1 by its bytes
    ops, nbytes = pixels.render_work(512, c)
    assert ops == 420 * 512 * 3072 and nbytes == 16 * 512 * 3072 + 28 * 512
    ops, nbytes = pixels.k1_work(512, c)
    assert ops == (30 + 8 * 175) * 512 and nbytes == 33 * 4 * 512
    # an update of 512 envs x 32 steps, 2 epochs
    assert pixels.update_flops(c, 512, 32) == \
        33 * 512 * fwd + 2 * 16384 * fwd_bwd \
        + 32 * (420 * 512 * 3072 + 1430 * 512)


def measure(cell, traced=False):
    return run.measure(cell, SEED, 0.05, traced, "cpu", time.perf_counter())


def test_tiny_run_is_correct():
    out = measure(tiny())
    assert out["correct"], out["numbers"]
    assert out["numbers"]["image_err"] == 0.0
    assert set(out["metrics"]) == {"train_env_steps_per_s",
                                   "update_ms_p95", "setup_s"}


def test_tiny_traced_run_reads_its_records():
    """The traced branch fills the program's records itself; on the CPU
    the device's metrics find no device operation and read nothing."""
    out = measure(tiny(), traced=True)
    assert out["correct"], out["numbers"]
    ctx = out["ctx"]
    for key in ("program_trace", "program_spans", "rollout_steps",
                "optimize_steps", "kernel_load_s"):
        assert key in ctx, key
    spans = ctx["program_spans"]
    assert spans["env.batched_step"]["count"] == TINY["rollout_steps"]
    assert spans["kernel.render"]["attrs"] == {
        "cameras": TINY["num_envs"] * TINY["rollout_steps"]}
    assert set(out["metrics"]) == {"batched_step_launches.rgb",
                                   "batched_step_host_ms.rgb",
                                   "mfu.train_rgb"}
    assert out["metrics"]["batched_step_launches.rgb"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["half_batch", "unchanged", "stale",
                                   "altered"])
def test_fault_is_not_correct(fault):
    cell = tiny()
    with calibrate_rgb.FAULTS[fault]():
        out = measure(cell)
    assert not out["correct"], out["numbers"]
    numbers = out["numbers"]
    if fault == "unchanged":
        assert numbers["change_gap"] == pytest.approx(1.0)
    if fault in ("stale", "altered"):
        assert numbers["image_err"] > cell.limits["image_err"]["limit"]


def test_lower_precision_inside_update_is_not_correct(monkeypatch):
    """bfloat16 autocast around the update, as TF32 inside it would be on
    a card: `policy_gap`, read from the rollout's own forward passes,
    fails."""
    from gym_pybullet_drones_tpu_torch.rl import ppo
    real = ppo.make_train

    def make(*args, **kwargs):
        init, update, evaluate, net = real(*args, **kwargs)

        def lower(ts, draws=None, after_rollout=None):
            with torch.autocast("cpu", dtype=torch.bfloat16):
                return update(ts, draws, after_rollout)
        lower.env_path = update.env_path
        return init, lower, evaluate, net
    monkeypatch.setattr(ppo, "make_train", make)
    cell = tiny()
    out = measure(cell)
    assert not out["correct"]
    assert out["numbers"]["policy_gap"] > cell.limits["policy_gap"]["limit"]


def test_tf32_control_is_not_correct(card):
    """TF32 inside the program's convolutions and products (a card only),
    at 64 envs."""
    cell = cells.load(WORKLOAD)
    cell.traffic.update(num_envs=64, trace_updates=1)
    numbers = calibrate_rgb.reading(cell, SEED, card, "tf32")
    assert numbers["policy_gap"] > cell.limits["policy_gap"]["limit"]
    assert calibrate_rgb.reading(cell, SEED, card)["policy_gap"] \
        <= cell.limits["policy_gap"]["limit"]
