"""The controls that exist only on a card, at a size a test run holds: the
program with TF32 products switched on inside its calls fails the
training cell's comparison (`policy_gap`), and its sound run passes."""
import pytest

from portbench import calibrate, cell as cells, check

TRAIN = {"num_envs": 1024, "rollout_steps": 64, "trace_updates": 1}


@pytest.mark.usefixtures("card")
def test_tf32_control_fails_on_the_card():
    cell = cells.load("hover_dyn.train8192")
    cell.traffic.update(TRAIN)
    readings = []
    calibrate.train_readings(cell, [2 ** 31 + 5], [2 ** 31 + 7], "cuda:0",
                             readings.append)
    for r in readings:
        numbers = {k: r[k] for k in cell.limits if k in r}
        ok = check.judge(numbers, cell.limits)[0]
        assert ok == (r["kind"] == "sound"), r
