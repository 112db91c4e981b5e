"""The port's CFAviary (gym_pybullet_drones_tpu_torch/envs/cf_aviary.py)
against the JAX package's, on the CPU.

Each CONTROLLER ('mellinger', 'pid', 'dsl') flies the same short flight in
float64 on both sides from the same start and under the same commands: a
few control steps on the firmware's zero setpoint (the origin), a
commander takeoff, a goto and a full-state command.  The obs after every
control step, the PWMs, the tick count and the tumble counter are
compared.  Measured: obs within 5e-11, PWMs within 1.2e-10 (of some
4e4).  A tumble case flies an inverted drone into the ground under full
thrust until both sides kill the motors; and `examples/cf.py`'s `run` is
held against the JAX package's at 5% of its flight, in float32, to the
kernels' tolerances.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs.cf_aviary import CFAviary as JCFAviary
from gym_pybullet_drones_tpu.utils import enums as JE

from gym_pybullet_drones_tpu_torch.envs.cf_aviary import \
    CFAviary as TCFAviary
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import ATOL, RPM_TOL, RTOL

OBS_ATOL = 1e-9         # float64 obs; measured 5e-11
PWM_ATOL = 1e-6         # PWMs of some 4e4; measured 1.2e-10
# PYB world ang-vel columns: tests/test_pallas.py:241-259's tolerance
ANGV_TOL = dict(atol=5e-4, rtol=3e-4)


def _pair(controller, **kw):
    j = type("JCF", (JCFAviary,), {"CONTROLLER": controller})(
        dtype=jnp.float64, physics=JE.Physics.PYB, **kw)
    t = type("TCF", (TCFAviary,), {"CONTROLLER": controller})(
        dtype=torch.float64, physics=TE.Physics.PYB, device="cpu", **kw)
    return j, t


def _fly(envs, steps, commands):
    """`steps` control steps of both aviaries; `commands` holds (control
    step, method, arguments) in the order they are sent."""
    for i in range(steps):
        for env in envs:
            for _, name, args in (c for c in commands if c[0] == i):
                getattr(env, name)(*args)
        (jo, *_), (to, *_) = (env.step(i) for env in envs)
        assert to.dtype == np.float64 and to.shape == jo.shape == (1, 20)
        np.testing.assert_allclose(to, jo, rtol=0, atol=OBS_ATOL,
                                   err_msg=f"obs after control step {i}")
        j, t = envs
        np.testing.assert_allclose(t.pwms, j.pwms, rtol=0, atol=PWM_ATOL)
        assert (t.tick, t.tumble_counter, t._error) == \
            (j.tick, j.tumble_counter, j._error)


@pytest.mark.parametrize("controller,freq,steps", [
    ("mellinger", 500, 8), ("pid", 1000, 6), ("dsl", 1000, 4)])
def test_cf_aviary_matches_jax(controller, freq, steps):
    """A short flight of each controller: two control steps on the zero
    setpoint, a takeoff through the high-level commander, a relative goto,
    then a full-state command with a yaw and a body-rate setpoint."""
    envs = _pair(controller, initial_xyzs=np.array([[0.1, -0.1, 0.2]]),
                 pyb_freq=freq, ctrl_freq=25)
    _fly(envs, steps, [
        (1, "sendTakeoffCmd", (0.6, 0.3)),
        (2, "sendGotoCmd", ([0.2, 0.1, 0.0], 0.3, 0.2, True)),
        (steps - 1, "sendFullStateCmd", (
            [0.3, 0.1, 0.5], np.zeros(3), [0.0, 0.0, 0.5], 0.2,
            [0.0, 0.0, 0.3], (steps - 1) / 25))])
    assert envs[1].takeoff_sent and len(envs[1].states_log) == \
        len(envs[0].states_log)
    np.testing.assert_allclose(np.asarray(envs[1].states_log),
                               np.asarray(envs[0].states_log), rtol=0,
                               atol=OBS_ATOL)


def test_cf_aviary_tumble_kills_motors_like_jax():
    """An inverted drone under a full-state command that asks for 40 m/s^2
    down: full thrust toward the ground, the world-frame finite-difference
    acceleration below -0.5 g for 30 ticks, then the motors killed on both
    sides at the same tick."""
    envs = _pair("mellinger", initial_xyzs=np.array([[0.0, 0.0, 5.0]]),
                 initial_rpys=np.array([[np.pi, 0.0, 0.0]]), pyb_freq=500,
                 ctrl_freq=25)
    _fly(envs, 6, [(0, "sendFullStateCmd", (
        [0.0, 0.0, 5.0], np.zeros(3), [0.0, 0.0, -40.0], 0.0, np.zeros(3),
        0.0))])
    j, t = envs
    assert t._error and j._error
    assert np.all(t.pwms == 0) and np.all(t.action == 0)


def test_cf_example_matches_jax(tmp_path):
    """`examples/cf.py`'s run at 5% of its flight (26 control steps, 520
    firmware ticks), float32 on both sides: the logged states within the
    kernels' tolerances (the ang-vel rows PYB's, the rpm rows the
    embedded-PID paths')."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from examples.cf import run as jrun
    from gym_pybullet_drones_tpu_torch.examples.cf import run as trun
    jl = jrun(plot=False, output_folder=str(tmp_path / "jax"),
              duration_fraction=0.05)
    tl = trun(plot=False, output_folder=str(tmp_path / "torch"),
              duration_fraction=0.05, device="cpu")
    assert tl.states.shape == jl.states.shape == (1, 16, 26)
    # logger rows: pos, vel, rpy, ang vel, rpm
    np.testing.assert_allclose(tl.states[0, :9], jl.states[0, :9],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tl.states[0, 9:12], jl.states[0, 9:12],
                               **ANGV_TOL)
    np.testing.assert_allclose(tl.states[0, 12:], jl.states[0, 12:],
                               **RPM_TOL)
