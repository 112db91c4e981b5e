"""The port's firmware stack (gym_pybullet_drones_tpu_torch/control/
firmware.py, firmware_pid.py, ctbr.py, commander.py) against the JAX
package's, on the CPU, in float64.

The JAX modules are held to the C++ firmware oracle at 1e-6 by
tests/test_firmware_oracle.py; here the port is held to the JAX modules
over the same takeoff -> goto -> land sequences, tick for tick, with both
sides given the same inputs each tick and the plant advanced on the JAX
side's output (so a difference is the controllers' alone).  Measured on
this configuration: the Mellinger control within 7.3e-12 of control
counts up to 6e4, the firmware PID's outputs within 3.6e-12 (its carried
PIDs within 4.4e-16 of each other), the LPF, power distribution, motor
curve and commander bit for bit; held to `CONTROL_ATOL`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.control import commander as jcmd
from gym_pybullet_drones_tpu.control import ctbr as jctbr
from gym_pybullet_drones_tpu.control import firmware as jfw
from gym_pybullet_drones_tpu.control import firmware_pid as jfp
from gym_pybullet_drones_tpu.ops import quat as jquat

from gym_pybullet_drones_tpu_torch.control import commander as tcmd
from gym_pybullet_drones_tpu_torch.control import ctbr as tctbr
from gym_pybullet_drones_tpu_torch.control import firmware as tfw
from gym_pybullet_drones_tpu_torch.control import firmware_pid as tfp

F64 = jnp.float64
T64 = torch.float64
# control_t counts reach 6e4; 1e-9 is some 140 float64 ulps there
CONTROL_ATOL = 1e-9


def _t(x):
    return torch.tensor(np.asarray(x, np.float64), dtype=T64)


def _j(x):
    return jnp.asarray(np.asarray(x, np.float64), F64)


@pytest.mark.parametrize("cutoff", [80.0, 30.0])
def test_lpf2p_matches_jax(cutoff):
    """The 2-pole Butterworth LPF at 500 Hz, the firmware's two cutoffs,
    over 500 noisy samples of a (3,) signal: bit for bit."""
    jc, tc = jfw.lpf2p_coeffs(500.0, cutoff), tfw.lpf2p_coeffs(500.0, cutoff)
    assert jc == tc
    js, ts = jfw.lpf2p_init((3,), F64), tfw.lpf2p_init((3,), T64)
    rng = np.random.default_rng(3)
    for i in range(500):
        x = np.sin(0.07 * i + np.arange(3)) + 0.3 * rng.normal(size=3)
        jy, js = jfw.lpf2p_apply(jc, js, _j(x))
        ty, ts = tfw.lpf2p_apply(tc, ts, _t(x))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


@pytest.mark.parametrize("x_form", [True, False])
def test_power_distribution_matches_jax(x_form):
    """Power distribution and the brushed motor curve on 100 seeded
    control_t vectors (a batch), thrust past saturation included."""
    rng = np.random.default_rng(4)
    control = np.stack([rng.uniform(0, 80000, 100),
                        rng.uniform(-3e4, 3e4, 100),
                        rng.uniform(-3e4, 3e4, 100),
                        rng.uniform(-3e4, 3e4, 100)], axis=-1)
    mine = tfw.power_distribution(_t(control), quad_formation_x=x_form)
    ref = jfw.power_distribution(_j(control), quad_formation_x=x_form)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    thrust = rng.uniform(0, 70000, 100)
    np.testing.assert_array_equal(tfw.motors_get_pwm(_t(thrust)).numpy(),
                                  np.asarray(jfw.motors_get_pwm(_j(thrust))))


def _takeoff_goto_land_waypoints(n_ticks, dt):
    """tests/test_firmware_oracle.py's schedule: takeoff (0 -> 0.5 m),
    goto (+0.4 m x), land."""
    t = np.arange(n_ticks) * dt
    z = np.clip(t / 2.0, 0, 1) * 0.5
    z = np.where(t > 6.0, np.maximum(0.0, 0.5 - 0.5 * (t - 6.0) / 2.0), z)
    x = np.clip((t - 3.0) / 2.0, 0, 1) * 0.4
    return np.stack([x, np.zeros_like(t), z], axis=-1)


def test_mellinger_matches_jax_takeoff_goto_land():
    """tests/test_firmware_oracle.py:65's closed loop, the port against the
    JAX controller: the same setpoint, state and gyro each tick, the crude
    plant advanced on the JAX output; the carried state compared too."""
    dt = 1.0 / 500.0
    n_ticks = 5 * 500
    wps = _takeoff_goto_land_waypoints(n_ticks, dt)
    js, ts = jfw.firmware_init(F64), tfw.firmware_init(T64)
    # one compile for the 500 ticks, where eager dispatch pays each op
    j_mellinger = jax.jit(jfw.mellinger_control, static_argnums=6)
    pos, vel, rpy, gyro_deg = (np.zeros(3) for _ in range(4))
    # a setpoint yaw other than 0, so the desired-yaw path acts
    sp_q = np.asarray(jquat.rpy_to_quat(_j([0.0, 0.0, 0.3])))
    max_err = 0.0
    for i in range(0, n_ticks, 5):
        quat = np.asarray(jquat.rpy_to_quat(_j(rpy)))
        jsp = jfw.Setpoint(_j(wps[i]), _j(np.zeros(3)), _j([0.0, 0.0, 0.1]),
                           _j([1.0, -2.0, 0.5]), _j(sp_q))
        tsp = tfw.Setpoint(*(_t(np.asarray(v)) for v in jsp))
        jc, js = j_mellinger(js, jsp, _j(pos), _j(vel), _j(quat),
                             _j(gyro_deg), dt)
        tc, ts = tfw.mellinger_control(ts, tsp, _t(pos), _t(vel), _t(quat),
                                       _t(gyro_deg), dt)
        jc = np.asarray(jc)
        max_err = max(max_err, float(np.abs(tc.numpy() - jc).max()))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-12)
        thrust_acc = jc[0] / jfw.MASS_THRUST / jfw.VEHICLE_MASS
        acc = np.array([math.sin(rpy[1]), -math.sin(rpy[0]),
                        math.cos(rpy[0]) * math.cos(rpy[1])]) * thrust_acc \
            - np.array([0.0, 0.0, 9.81])
        vel = vel + 5 * dt * acc
        pos = pos + 5 * dt * vel
        rpy_rate = np.array([jc[1], -jc[2], jc[3]]) / 6e5
        rpy = 0.95 * rpy + 5 * dt * rpy_rate
        gyro_deg = rpy_rate * 180.0 / math.pi * 0.2
    assert max_err <= CONTROL_ATOL, max_err


def test_fwpid_cascade_matches_jax():
    """tests/test_firmware_oracle.py:116's sequence: the 100 Hz position
    loop, two 500 Hz attitude ticks after each, a random walk of the
    attitude state driven by the JAX output; every carried PID compared."""
    dt_pos, dt_att = 1.0 / 100.0, 1.0 / 500.0
    js, ts = jfp.init_state(F64), tfp.init_state(T64)
    n = 600
    wps = _takeoff_goto_land_waypoints(n, dt_pos)
    pos, vel, rpy_deg, gyro_deg = (np.zeros(3) for _ in range(4))
    rng = np.random.default_rng(5)
    max_err = 0.0

    # one compile each for the 600 and 1200 calls
    j_position = jax.jit(jfp.position_controller, static_argnums=1)
    j_attitude = jax.jit(jfp.attitude_rate_controller, static_argnums=1)

    def leaves(s):
        return [x for f in s for x in (f if isinstance(f, tuple) else (f,))]
    for i in range(n):
        js = j_position(js, dt_pos, _j(pos), _j(vel), _j(rpy_deg[2]),
                        _j(wps[i]))
        ts = tfp.position_controller(ts, dt_pos, _t(pos), _t(vel),
                                     _t(rpy_deg[2]), _t(wps[i]))
        for _ in range(2):
            jout, js = j_attitude(js, dt_att, _j(rpy_deg), _j(gyro_deg),
                                  _j(170.0))
            tout, ts = tfp.attitude_rate_controller(
                ts, dt_att, _t(rpy_deg), _t(gyro_deg), _t(170.0))
            jout = np.array([float(v) for v in jout])
            tout = np.array([float(v) for v in tout])
            max_err = max(max_err, float(np.abs(tout - jout).max()))
            rpy_deg = rpy_deg + np.array([jout[1], -jout[2], -jout[3]]) \
                / 3e5 + rng.normal(scale=0.01, size=3)
            gyro_deg = (jout[1:4] * np.array([1, -1, -1])) / 3e4 \
                + rng.normal(scale=0.05, size=3)
        for a, b in zip(leaves(ts), leaves(js)):
            np.testing.assert_allclose(float(a), float(b), rtol=0,
                                       atol=CONTROL_ATOL)
        vel = vel + 0.02 * rng.normal(size=3)
        pos = pos + dt_pos * vel
    assert max_err <= CONTROL_ATOL, max_err


def test_commander_matches_jax():
    """tests/test_firmware.py:44's takeoff and relative goto, then a land,
    a goto while a plan runs, a stop and velocity takeoffs: the setpoints
    of both commanders at every 20 ms, bit for bit."""
    cmds = [jcmd.HighLevelCommander(), tcmd.HighLevelCommander()]
    script = {0.0: ("tell_state", ([0, 0, 0.1], 0.0)),
              0.02: ("takeoff", (1.0, 2.0)),
              3.0: ("go_to", (1.0, 0.0, 0.0, 0.3, 2.0, True)),
              4.0: ("go_to", (0.5, 0.5, 1.2, -0.2, 1.5, False)),
              6.0: ("land", (0.05, 2.0, 0.1)),
              8.5: ("stop", ()),
              8.6: ("tell_state", ([0.2, 0.1, 0.05], 0.4)),
              8.8: ("takeoff_with_velocity", (0.6, 0.5, True)),
              10.5: ("land_with_velocity", (0.1, 0.4, False))}
    for k in range(600):
        t = round(k * 0.02, 10)
        for c in cmds:
            c.update_time(t)
            if t in script:
                name, args = script[t]
                getattr(c, name)(*args)
        (jp, jv, ja, jy), (tp, tv, ta, ty) = (c.get_setpoint() for c in cmds)
        for a, b in ((tp, jp), (tv, jv), (ta, ja)):
            np.testing.assert_array_equal(a, b)
        assert ty == jy and cmds[0].is_flying == cmds[1].is_flying
    # tests/test_firmware.py:44's profile, on the port
    c = tcmd.HighLevelCommander()
    c.tell_state([0, 0, 0.1], 0.0)
    c.update_time(0.0)
    c.takeoff(1.0, 2.0)
    c.update_time(2.5)
    np.testing.assert_allclose(c.get_setpoint()[0], [0, 0, 1.0], atol=1e-12)


def test_compute_ctbr_matches_jax():
    """`compute_ctbr` on 64 seeded states and targets (a batch, tilted and
    yawed attitudes, a target velocity) and one unbatched call through
    `CTBRControl`, float64."""
    rng = np.random.default_rng(6)
    b = 64
    pos = rng.normal(size=(b, 3))
    rpy = rng.uniform(-1.0, 1.0, size=(b, 3)) * [0.8, 0.8, 3.0]
    quat = np.asarray(jquat.rpy_to_quat(_j(rpy)))
    vel = rng.normal(size=(b, 3))
    tpos = pos + rng.normal(size=(b, 3))
    tvel = 0.3 * rng.normal(size=(b, 3))
    for tv in (None, tvel):
        jt, jr = jctbr.compute_ctbr(_j(pos), _j(quat), _j(vel), _j(tpos),
                                    None if tv is None else _j(tv))
        tt, tr = tctbr.compute_ctbr(_t(pos), _t(quat), _t(vel), _t(tpos),
                                    None if tv is None else _t(tv))
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-12)
    state = np.concatenate([pos[0], quat[0], rpy[0], vel[0],
                            rng.normal(size=3), np.zeros(4)])
    jout = jctbr.CTBRControl().computeControlFromState(
        1 / 500, _j(state), tpos[0], target_vel=tvel[0])
    tout = tctbr.CTBRControl().computeControlFromState(
        1 / 500, state, tpos[0], target_vel=tvel[0])
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-12)
