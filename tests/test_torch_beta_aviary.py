"""The port's BetaAviary (gym_pybullet_drones_tpu_torch/envs/beta_aviary.py)
and its native SITL bridge against the JAX package's, on the CPU.

Every socket here binds 127.0.0.2 (the port) or 127.0.0.3 (the JAX
package), never 127.0.0.1, whose ports 9002-9004 and 9072-9074 the JAX
package's own tests bind in other workers at the same time.  All of this
file's sockets live in this one file, which one worker runs alone; every
wait on a socket has its own timeout.

The wire test drives both packages' BetaAviary with the same action
schedule across the disarmed (t < 1 s), armed and trajectory (t > 1.5 s)
phases, reads every FDM and RC packet each side sends from listener
sockets in the test, and answers with a fixed PWM packet from t = 1.2 s
on: the unpacked fields must agree (floats to the obs tolerance, integers
equal), and the PWM must reach the motors as the same rpm on both sides
one control step later.
"""
import shutil
import socket
import struct

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu import native as jnative
from gym_pybullet_drones_tpu.envs import beta_aviary as jbeta
from gym_pybullet_drones_tpu.utils import enums as JE

from gym_pybullet_drones_tpu_torch import native as tnative
from gym_pybullet_drones_tpu_torch.envs import beta_aviary as tbeta
from gym_pybullet_drones_tpu_torch.params import CF2X
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import ATOL, RTOL, pair

PORT_IP, JAX_IP = "127.0.0.2", "127.0.0.3"
FDM_FMT, RC_FMT = "@dddddddddddddddddd", "@dHHHHHHHHHHHHHHHH"
WAIT_S = 2.0            # each socket wait
PWM_REPLY = (0.1, 0.2, 0.3, 0.4)
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native bridge")


def test_ctbr2beta_matches_jax():
    """The RC channel mapping on seeded commands past both clips."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        cmd = (rng.uniform(-5, 50), *rng.uniform(-8, 8, size=3))
        np.testing.assert_array_equal(tbeta.BetaAviary.ctbr2beta(*cmd),
                                      jbeta.BetaAviary.ctbr2beta(*cmd))
    thro, r, p, y = tbeta.BetaAviary.ctbr2beta(20.45, 0.0, 0.0, 0.0)
    assert abs(thro - 1500) < 1 and r == p == y == 1500


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_beta_task_rpm_matches_jax(dtype):
    """`_BetaTask`: PWM fractions -> rpm with the [2, 1, 3, 0] remap, on
    a (3, 4) batch of seeded fractions."""
    import jax.numpy as jnp
    (jcfg, _), (tcfg, _) = pair()
    u = np.random.default_rng(1).uniform(0, 1, size=(3, 4)).astype(dtype)
    jrpm, _ = jbeta._BetaTask().preprocess_action(jcfg, None,
                                                  jnp.asarray(u))
    trpm, _ = tbeta._BetaTask().preprocess_action(tcfg, None,
                                                  torch.from_numpy(u))
    np.testing.assert_allclose(trpm.numpy(), np.asarray(jrpm), rtol=1e-7,
                               atol=0)
    np.testing.assert_allclose(
        trpm.numpy()[:, 0],
        np.sqrt(tcfg.drone.max_thrust / 4 / tcfg.drone.kf * u[:, 2]),
        rtol=1e-6)


def _listeners(ip, n):
    """Per drone, sockets on `ip` bound to its FDM and RC ports, and one
    to send its PWM replies."""
    socks = []
    for j in range(n):
        pair_ = []
        for base in (tbeta.BASE_PORT_STATE, tbeta.BASE_PORT_RC):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.bind((ip, base + 10 * j))
            s.settimeout(WAIT_S)
            pair_.append(s)
        socks.append(pair_)
    return socks, socket.socket(socket.AF_INET, socket.SOCK_DGRAM)


def _schedule(n_steps, n):
    t = np.arange(n_steps)[:, None]
    d = np.arange(n)[None, :]
    return np.stack([10.0 + 2.0 * np.sin(0.1 * t + d),
                     0.3 * np.sin(0.2 * t + d), 0.2 * np.cos(0.2 * t + 0 * d),
                     0.1 * np.sin(0.05 * t - d)], axis=-1)


def _wire_run(native_bridge):
    """Both packages' BetaAviary (2 drones, PYB, 240 / 48 Hz) over 80
    control steps; returns per side the unpacked packets and the rpm
    applied after each step."""
    n, steps = 2, 80
    actions = _schedule(steps, n)
    xyz = np.array([[0.0, 0.0, 0.5], [0.3, 0.3, 0.6]])
    out = {}
    for side, mod, ip, phys in (
            ("jax", jbeta, JAX_IP, JE.Physics.PYB),
            ("torch", tbeta, PORT_IP, TE.Physics.PYB)):
        socks, reply = _listeners(ip, n)
        kw = {} if side == "jax" else {"device": "cpu"}
        env = None
        try:
            env = mod.BetaAviary(num_drones=n, initial_xyzs=xyz,
                                 physics=phys, pyb_freq=240, ctrl_freq=48,
                                 udp_ip=ip, use_native_bridge=native_bridge,
                                 **kw)
            fdm, rc, rpm = [], [], []
            for i in range(steps):
                env.step(actions[i], i)
                rpm.append(np.asarray(env.state.last_rpm, np.float64))
                for j, (s_fdm, s_rc) in enumerate(socks):
                    fdm.append(struct.unpack(FDM_FMT, s_fdm.recv(1024)))
                    rc.append(struct.unpack(RC_FMT, s_rc.recv(1024)))
                    if i / 48 >= 1.2:
                        reply.sendto(struct.pack("@ffff", *PWM_REPLY),
                                     (ip, tbeta.BASE_PORT_PWM + 10 * j))
            out[side] = (np.array(fdm), np.array(rc), np.stack(rpm),
                         env.beta_action.copy())
        finally:
            if env is not None:
                env.close()
            for s in [s for p in socks for s in p] + [reply]:
                s.close()
    return out, actions


@pytest.mark.parametrize("native_bridge", [
    False, pytest.param(True, marks=needs_gxx)],
    ids=["python_sockets", "native_bridge"])
def test_beta_wire_matches_jax(native_bridge):
    out, actions = _wire_run(native_bridge)
    (jf, jr, jrpm, ja), (tf, tr, trpm, ta) = out["jax"], out["torch"]
    assert tf.shape == jf.shape == (160, 18)
    assert tr.shape == jr.shape == (160, 17)
    # FDM: the time and the placeholders equal, the body rates (ENU ->
    # NED) to the obs tolerance
    np.testing.assert_array_equal(tf[:, [0, *range(4, 18)]],
                                  jf[:, [0, *range(4, 18)]])
    np.testing.assert_allclose(tf[:, 1:4], jf[:, 1:4], atol=ATOL, rtol=RTOL)
    assert np.abs(tf[:, 1:4]).max() > 0
    # RC: every channel equal, through the disarmed, armed and trajectory
    # phases
    np.testing.assert_array_equal(tr, jr)
    assert set(tr[:, 5]) == {1000, 1500}
    assert len(set(tr[:, 3])) > 2           # throttle follows the schedule
    # the fixed PWM reply reaches the motors one step later on both sides
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ta, np.tile(np.float32(PWM_REPLY), (2, 1)))
    np.testing.assert_allclose(trpm, jrpm, rtol=1e-6, atol=0)
    u = np.float32(PWM_REPLY)[[2, 1, 3, 0]]
    np.testing.assert_allclose(
        trpm[-1], np.tile(np.sqrt(CF2X.max_thrust / 4 / CF2X.kf * u),
                          (2, 1)), rtol=1e-6)
    assert np.all(trpm[0] == 0)             # no PWM before the reply


@needs_gxx
def test_sitl_bridge_tick_matches_jax():
    """`native.SitlBridge.tick`, the port's (127.0.0.2) and the JAX
    package's (127.0.0.3), drone index 7: the same bytes on the wire, and
    a PWM packet picked up on the next tick."""
    idx = 7
    rc = np.array([1500, 1400, 1000, 1600] + [1000] * 12, np.uint16)
    packets = {}
    for side, mod, ip in (("jax", jnative, JAX_IP),
                          ("torch", tnative, PORT_IP)):
        socks, reply = _listeners(ip, idx + 1)
        bridge = None
        try:
            bridge = mod.SitlBridge(ip, idx)
            fresh, _ = bridge.tick(0.25, [0.1, -0.2, 0.3], rc)
            assert not fresh
            s_fdm, s_rc = socks[idx]
            got = [s_fdm.recv(1024), s_rc.recv(1024)]
            reply.sendto(struct.pack("@ffff", *PWM_REPLY),
                         (ip, tbeta.BASE_PORT_PWM + 10 * idx))
            fresh, pwm = bridge.tick(0.3, [0.0, 0.0, 0.0], rc)
            got += [s_fdm.recv(1024), s_rc.recv(1024)]
            packets[side] = (got, fresh, pwm)
        finally:
            if bridge is not None:
                bridge.close()
            for s in [s for p in socks for s in p] + [reply]:
                s.close()
    (jg, jfresh, jpwm), (tg, tfresh, tpwm) = packets["jax"], packets["torch"]
    assert tg == jg
    fdm = struct.unpack(FDM_FMT, tg[0])
    assert fdm[0] == 0.25 and fdm[1:4] == (0.1, 0.2, -0.3)
    assert struct.unpack(RC_FMT, tg[1])[1:5] == (1500, 1400, 1000, 1600)
    assert tfresh and jfresh
    np.testing.assert_array_equal(tpwm, jpwm)
    np.testing.assert_allclose(tpwm, PWM_REPLY, rtol=1e-6)


def test_beta_aviary_free_falls_without_sitl():
    """tests/test_firmware.py:92 on the port: no SITL answers, so no PWM
    ever arrives, the motors stay off and the drone falls."""
    env = tbeta.BetaAviary(num_drones=1, physics=TE.Physics.PYB,
                           pyb_freq=240, ctrl_freq=48, udp_ip=PORT_IP,
                           device="cpu")
    try:
        obs, _ = env.reset()
        for i in range(10):
            obs, *_ = env.step(np.zeros((1, 4)), i)
        assert obs.shape == (1, 20)
        assert obs[0, 2] < 0.12 and np.all(env.beta_action == 0)
    finally:
        env.close()


def test_beta_example_runs_without_sitl(tmp_path):
    """`examples/beta.py` on 127.0.0.2 past TRAJ_TIME (1.6 s at 500 Hz), no
    SITL: the CTBR controller computes commands from the shipped
    trajectory, no PWM arrives, the drone falls to the ground."""
    from gym_pybullet_drones_tpu_torch.examples.beta import run
    logger = run(num_drones=1, duration_sec=1.6, plot=False,
                 output_folder=str(tmp_path), udp_ip=PORT_IP, device="cpu")
    st = logger.states[0]
    assert st.shape[1] == 800 and np.all(np.isfinite(st))
    assert st[2, -1] < st[2, 0] and st[2, -1] < 0.05
