"""The port's firmware (gym_pybullet_drones_tpu_torch/control/firmware.py,
firmware_pid.py) against the port's own C++ firmware oracle
(native/cf_firmware_oracle.cpp, built with g++ into build/native/), in
float64 on the CPU, over tests/test_firmware_oracle.py's four sequences at
that file's bounds: the LPF 1e-9, the power distribution 1e-8, the
Mellinger closed loop 0.05 (control counts reach 6e4), the firmware PID
cascade 1e-6.  Both sides get the same inputs each tick and the plant
advances on the oracle's output, so a difference is the controllers'
alone.  Measured on the CPU: the LPF, the power distribution and the
PID cascade bit for bit, the Mellinger loop within 7.3e-12.

The port's oracle is also held against the JAX package's build of its
own copy of the source: the same outputs, bit for bit, on the same
inputs."""
import math
import shutil

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.native import firmware_oracle as jfo

from gym_pybullet_drones_tpu_torch import native as tnative
from gym_pybullet_drones_tpu_torch.control import firmware as tfw
from gym_pybullet_drones_tpu_torch.control import firmware_pid as tfp
from gym_pybullet_drones_tpu_torch.native import firmware_oracle as fo
from gym_pybullet_drones_tpu_torch.ops.quat import rpy_to_quat

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the firmware oracle")
T64 = torch.float64
IDENTITY_Q = np.array([0.0, 0.0, 0.0, 1.0])


def _t(x):
    return torch.tensor(np.asarray(x, np.float64), dtype=T64)


def _takeoff_goto_land_waypoints(n_ticks, dt):
    """tests/test_firmware_oracle.py's schedule: takeoff (0 -> 0.5 m),
    goto (+0.4 m x), land."""
    t = np.arange(n_ticks) * dt
    z = np.clip(t / 2.0, 0, 1) * 0.5
    z = np.where(t > 6.0, np.maximum(0.0, 0.5 - 0.5 * (t - 6.0) / 2.0), z)
    x = np.clip((t - 3.0) / 2.0, 0, 1) * 0.4
    return np.stack([x, np.zeros_like(t), z], axis=-1)


@pytest.mark.parametrize("cutoff", [80.0, 30.0])
def test_lpf2p_matches_oracle(cutoff):
    """The 2-pole Butterworth LPF, 500 Hz sample, the firmware's cutoffs,
    over 500 noisy samples."""
    coeffs = tfw.lpf2p_coeffs(500.0, cutoff)
    st = tfw.lpf2p_init((), T64)
    oracle = fo.Lpf2pOracle(500.0, cutoff)
    rng = np.random.default_rng(3)
    for i in range(500):
        x = math.sin(0.07 * i) + 0.3 * rng.normal()
        y, st = tfw.lpf2p_apply(coeffs, st, _t(x))
        assert abs(float(y) - oracle.apply(x)) < 1e-9, f"tick {i}"


@pytest.mark.parametrize("x_form", [True, False], ids=["x", "plus"])
def test_power_distribution_matches_oracle(x_form):
    rng = np.random.default_rng(4)
    control = np.stack([rng.uniform(0, 65535, 100),
                        rng.uniform(-3e4, 3e4, 100),
                        rng.uniform(-3e4, 3e4, 100),
                        rng.uniform(-3e4, 3e4, 100)], axis=-1)
    mine = tfw.power_distribution(_t(control), quad_formation_x=x_form)
    want = np.stack([fo.power_distribution(c, quad_formation_x=x_form)
                     for c in control])
    np.testing.assert_allclose(mine.numpy(), want, rtol=0, atol=1e-8)


def test_mellinger_matches_oracle_takeoff_goto_land():
    """tests/test_firmware_oracle.py:65's closed loop: 5 s of the 500 Hz
    controller sampled at 100 Hz, a crude plant driven by the oracle."""
    dt = 1.0 / 500.0
    n_ticks = 5 * 500
    wps = _takeoff_goto_land_waypoints(n_ticks, dt)
    state = tfw.firmware_init(T64)
    oracle = fo.MellingerOracle()
    pos, vel, rpy, gyro_deg = (np.zeros(3) for _ in range(4))
    zeros = _t(np.zeros(3))
    max_err = 0.0
    for i in range(0, n_ticks, 5):
        quat = rpy_to_quat(_t(rpy)).numpy()
        sp = tfw.Setpoint(_t(wps[i]), zeros, zeros, zeros, _t(IDENTITY_Q))
        mine, state = tfw.mellinger_control(state, sp, _t(pos), _t(vel),
                                            _t(quat), _t(gyro_deg), dt)
        ref = oracle.tick(wps[i], np.zeros(3), np.zeros(3), np.zeros(3),
                          IDENTITY_Q, pos, vel, quat, gyro_deg, dt)
        max_err = max(max_err, float(np.abs(mine.numpy() - ref).max()))
        thrust_acc = ref[0] / tfw.MASS_THRUST / tfw.VEHICLE_MASS
        acc = np.array([math.sin(rpy[1]), -math.sin(rpy[0]),
                        math.cos(rpy[0]) * math.cos(rpy[1])]) * thrust_acc \
            - np.array([0.0, 0.0, 9.81])
        vel = vel + 5 * dt * acc
        pos = pos + 5 * dt * vel
        rpy_rate = np.array([ref[1], -ref[2], ref[3]]) / 6e5
        rpy = 0.95 * rpy + 5 * dt * rpy_rate
        gyro_deg = rpy_rate * 180.0 / math.pi * 0.2
    # the drone left the ground and the loop ran the whole schedule
    assert pos[2] > 0.1
    assert max_err < 0.05, f"max |port - C++| = {max_err}"


def test_fwpid_cascade_matches_oracle():
    """tests/test_firmware_oracle.py:116's sequence: the 100 Hz position
    loop, two 500 Hz attitude ticks after each, a random walk of the
    attitude state driven by the oracle's output."""
    dt_pos, dt_att = 1.0 / 100.0, 1.0 / 500.0
    state = tfp.init_state(T64)
    oracle = fo.FirmwarePidOracle()
    n = 600
    wps = _takeoff_goto_land_waypoints(n, dt_pos)
    pos, vel, rpy_deg, gyro_deg = (np.zeros(3) for _ in range(4))
    rng = np.random.default_rng(5)
    max_err = 0.0
    for i in range(n):
        state = tfp.position_controller(state, dt_pos, _t(pos), _t(vel),
                                        _t(rpy_deg[2]), _t(wps[i]))
        oracle.position(dt_pos, pos, vel, rpy_deg[2], wps[i])
        np.testing.assert_allclose(float(state.thrust), oracle.thrust,
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(float(state.des_roll), oracle.des_roll,
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(float(state.des_pitch), oracle.des_pitch,
                                   rtol=0, atol=1e-9)
        for _ in range(2):
            mine, state = tfp.attitude_rate_controller(
                state, dt_att, _t(rpy_deg), _t(gyro_deg), _t(0.0))
            ref = oracle.attitude(dt_att, rpy_deg, gyro_deg, 0.0)
            mine = np.array([float(v) for v in mine])
            max_err = max(max_err, float(np.abs(mine - ref).max()))
            rpy_deg = rpy_deg + np.array([ref[1], -ref[2], -ref[3]]) / 3e5 \
                + rng.normal(scale=0.01, size=3)
            gyro_deg = (ref[1:4] * np.array([1, -1, -1])) / 3e4 \
                + rng.normal(scale=0.05, size=3)
        vel = vel + 0.02 * rng.normal(size=3)
        pos = pos + dt_pos * vel
    assert max_err < 1e-6, f"max |port - C++| = {max_err}"


def test_oracle_matches_jax_package_build():
    """The port's copy of the source and the JAX package's, each built by
    its own package: the same outputs on the same seeded inputs, bit for
    bit (LPF, power distribution, 200 Mellinger and PID ticks)."""
    rng = np.random.default_rng(6)
    mine, ref = fo.Lpf2pOracle(500.0, 80.0), jfo.Lpf2pOracle(500.0, 80.0)
    for x in rng.normal(size=50):
        assert mine.apply(x) == ref.apply(x)
    for _ in range(20):
        c = rng.uniform(-3e4, 6e4, 4)
        for x_form in (True, False):
            np.testing.assert_array_equal(
                fo.power_distribution(c, x_form),
                jfo.power_distribution(c, x_form))
    mel = (fo.MellingerOracle(), jfo.MellingerOracle())
    pid = (fo.FirmwarePidOracle(), jfo.FirmwarePidOracle())
    for _ in range(200):
        q = rng.normal(size=4)
        args = (rng.normal(size=3), rng.normal(size=3), rng.normal(size=3),
                rng.normal(size=3) * 30, IDENTITY_Q, rng.normal(size=3),
                rng.normal(size=3), q / np.linalg.norm(q),
                rng.normal(size=3) * 30, 0.002)
        np.testing.assert_array_equal(mel[0].tick(*args), mel[1].tick(*args))
        p, v, rpy, gyro = (rng.normal(size=3) for _ in range(4))
        for o in pid:
            o.position(0.01, p, v, rpy[2] * 30, p + 0.1)
        assert (pid[0].thrust, pid[0].des_roll, pid[0].des_pitch) == (
            pid[1]._st.thrust, pid[1]._st.des_roll, pid[1]._st.des_pitch)
        np.testing.assert_array_equal(
            pid[0].attitude(0.002, rpy * 30, gyro * 30, 10.0),
            pid[1].attitude(0.002, rpy * 30, gyro * 30, 10.0))


def test_available(monkeypatch):
    """`native.available()` and `firmware_oracle.available()` (the JAX
    package's probes) are True where g++ builds the sources, and False,
    not an exception, where a build fails."""
    assert tnative.available() and fo.available()

    def fail():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(tnative, "_oracle_lib", fail)
    monkeypatch.setattr(fo, "_lib", fail)
    assert not tnative.available() and not fo.available()


def test_oracle_checks_its_inputs():
    """A vector of the wrong length raises before the C code reads it."""
    with pytest.raises(ValueError, match=r"\(4,\)"):
        fo.power_distribution(np.zeros(3))
    with pytest.raises(ValueError, match=r"\(3,\)"):
        fo.MellingerOracle().tick(np.zeros(2), *[np.zeros(3)] * 3,
                                  IDENTITY_Q, np.zeros(3), np.zeros(3),
                                  IDENTITY_Q, np.zeros(3), 0.002)
