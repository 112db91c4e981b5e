"""The port's examples (`gym_pybullet_drones_tpu_torch/examples/`) on the
CPU with tests/test_examples.py's assertions, at cut durations: the
port's per-env PYB step costs some 50 ms a control step on the host (pid:
3 drones and obstacles), and its batched PYB step, the plain version of
`env_ctrl_step`, some 0.3 s (swarm: 3 drones a fleet).  And the port's
Logger against the JAX package's: the same .npy arrays and CSV files from
the same log."""
import os

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread_agg():
    """Small tensors: one intra-op thread; matplotlib draws off screen."""
    import matplotlib
    matplotlib.use("Agg")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_pid(tmp_path):
    from gym_pybullet_drones_tpu_torch.examples.pid import run
    logger = run(gui=False, plot=False, output_folder=str(tmp_path),
                 duration_sec=1, device="cpu")
    # drones should track the circle at their initial altitudes
    for j in range(3):
        z = logger.states[j, 2, -48:]
        target_z = 0.1 + j * 0.05
        assert abs(float(np.mean(z)) - target_z) < 0.1


def test_pid_velocity(tmp_path):
    from gym_pybullet_drones_tpu_torch.examples.pid_velocity import run
    logger = run(gui=False, plot=False, output_folder=str(tmp_path),
                 duration_sec=1, device="cpu")
    # all drones moved and stayed finite
    assert np.all(np.isfinite(logger.states))
    assert float(np.max(np.abs(logger.states[:, 1, :]))) > 0.05  # y motion


def test_downwash(tmp_path):
    from gym_pybullet_drones_tpu_torch.examples.downwash import run
    logger = run(gui=False, plot=True, output_folder=str(tmp_path),
                 duration_sec=1, device="cpu")
    assert np.all(np.isfinite(logger.states))
    assert os.path.getsize(tmp_path / "flight_plot.png") > 0


def test_routing(tmp_path):
    """The fleet flies toward its goals: every drone ends nearer its goal
    than it started (1 s of the 10 s demo)."""
    from gym_pybullet_drones_tpu_torch.envs import make_routing_config
    from gym_pybullet_drones_tpu_torch.examples.routing import run
    err = run(num_drones=4, duration_sec=1, output_folder=str(tmp_path),
              plot=False, device="cpu")
    cfg, task = make_routing_config(4)
    start = np.linalg.norm(np.asarray(cfg.init_xyzs)
                           - np.asarray(task.destinations), axis=-1)
    assert err.shape == (4,) and np.all(np.isfinite(err))
    assert np.all(err < start)


def test_swarm(tmp_path):
    """2 s of flight, not tests/test_examples.py's 4: the scripted plan
    brings the drones within 15 cm of their goals in 2 s of simulated
    time."""
    from gym_pybullet_drones_tpu_torch.examples.swarm import run
    arrived = run(num_envs=2, num_drones=3, duration_sec=2,
                  render_frame=True, output_folder=str(tmp_path),
                  device="cpu")
    assert arrived > 0.5  # most drones reach their goals
    assert os.path.getsize(tmp_path / "swarm_frame.png") > 0


def test_logger_matches_jax(tmp_path):
    """tests/test_examples.py's Logger case, and the port's .npy arrays and
    CSV files against the JAX Logger's from the same log."""
    from gym_pybullet_drones_tpu.utils.logger import Logger as JLogger
    from gym_pybullet_drones_tpu_torch.utils.logger import Logger
    rng = np.random.default_rng(0)
    states = rng.normal(size=(10, 2, 20)) * 1000
    dirs = {}
    for name, cls in (("jax", JLogger), ("port", Logger)):
        lg = cls(logging_freq_hz=48, num_drones=2,
                 output_folder=str(tmp_path / name))
        for t in range(10):
            for d in range(2):
                lg.log(d, t / 48, states[t, d], np.full(12, t + d / 10))
        with open(lg.save(), "rb") as f:
            data = dict(np.load(f))
        dirs[name] = (data, lg.save_as_csv("t"))
    (jdata, jcsv), (data, csv) = dirs["jax"], dirs["port"]
    assert data["states"].shape == (2, 16, 10)
    # channel order: pos, vel, rpy, ang_vel, rpm (reference Logger.py:117)
    s = states[0, 0]
    np.testing.assert_array_equal(
        data["states"][0, :, 0],
        np.hstack([s[0:3], s[10:13], s[7:10], s[13:20]]))
    for k in ("timestamps", "states", "controls"):
        np.testing.assert_array_equal(data[k], jdata[k])
    assert sorted(os.listdir(csv)) == sorted(os.listdir(jcsv))
    assert "x0.csv" in os.listdir(csv) and "pwm3-1.csv" in os.listdir(csv)
    for f in os.listdir(csv):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(csv, f), delimiter=","),
            np.loadtxt(os.path.join(jcsv, f), delimiter=","), err_msg=f)


def test_debug_probes_match_jax():
    """`examples/debug.py`'s four probes (hover, lateral force, yaw torque,
    flying into the architrave beam) on the port's `pyb_step` against the
    JAX package's, float32 on both sides, from the same URDF obstacles."""
    import jax
    import jax.numpy as jnp
    from gym_pybullet_drones_tpu import params as JP
    from gym_pybullet_drones_tpu.ops.rigid_body import PybState, pyb_step
    from gym_pybullet_drones_tpu_torch import params as TP
    from gym_pybullet_drones_tpu_torch.examples.debug import DT, probes
    from tests._torch_helpers import ATOL, RTOL
    out = probes("cpu")
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    start = PybState(pos=f32([[0.0, 0.0, 1.0]]), quat=f32([[0, 0, 0, 1.0]]),
                     vel=f32([[0.0, 0.0, 0.0]]), ang_v=f32([[0.0, 0.0, 0.0]]))
    rpm = jnp.full((1, 4), JP.CF2X.hover_rpm, jnp.float32)
    obstacles = tuple(JP.load_obstacle_urdf(JP.obstacle_asset_path(n), p)
                      for n, p in (("architrave", (0.5, 0.0, 1.0)),
                                   ("box", (1.0, 0.0, 0.05))))
    assert obstacles == tuple(
        TP.load_obstacle_urdf(TP.obstacle_asset_path(n), p)
        for n, p in (("architrave", (0.5, 0.0, 1.0)),
                     ("box", (1.0, 0.0, 0.05))))
    zero = f32([[0.0, 0.0, 0.0]])
    runs = {"hover": (start, 240, zero, zero, ()),
            "force": (start, 120, f32([[0.01, 0.0, 0.0]]), zero, ()),
            "torque": (start, 120, zero, f32([[0.0, 0.0, 1e-5]]), ()),
            "obstacle": (start._replace(vel=f32([[0.5, 0.0, 0.0]])), 240,
                         zero, zero, obstacles)}
    # the external force and torque are arguments: one compile for the
    # three runs without obstacles, one for the run with them
    steps_of = {obst: jax.jit(lambda s, f, t, obst=obst: pyb_step(
        JP.CF2X, s, rpm, DT, ext_force=f, ext_torque=t, obstacles=obst))
        for obst in ((), obstacles)}
    for name, (s, steps, force, torque, obst) in runs.items():
        for _ in range(steps):
            s = steps_of[obst](s, force, torque)
        for k in ("pos", "quat", "vel", "ang_v"):
            np.testing.assert_allclose(getattr(out[name], k).numpy(),
                                       np.asarray(getattr(s, k)),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"{name} {k}")
    # the beam stops the drone short of its face
    assert float(out["obstacle"].pos[0, 0]) < 0.5
