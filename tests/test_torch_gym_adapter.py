"""The port's class adapters (`envs/gym_adapter.py`) against the JAX
package's: the four aviaries' spaces, reset observations and steps (each
step taken by both from the same state: re-anchored), the state vectors,
the adjacency matrix and the drone cameras; the headless GUI slider path
through `core.step(rpm_override=...)`, recording and image export.

The parity cases run DYN physics, whose JAX steps compile in a second or
two; the PYB family's `core.step` is held in tests/test_torch_pyb_slice.py
and tests/test_torch_envs.py, and the adapter is the same code over it.
"""
import os

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import gym_adapter as jad
from gym_pybullet_drones_tpu.ops import quat as jquat
from gym_pybullet_drones_tpu.utils import enums as JE
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import gym_adapter as tad
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import ATOL, PID_ATOL, RTOL, assert_render_close

# aviary -> (constructor arguments, the action of step t from a generator)
CASES = {
    "CtrlAviary": (dict(num_drones=2, pyb_freq=240, ctrl_freq=48),
                   lambda env, g: env.HOVER_RPM * (
                       1 + 0.05 * g.normal(size=(2, 4)))),
    "VelocityAviary": (dict(num_drones=2, pyb_freq=240, ctrl_freq=48),
                       lambda env, g: np.concatenate(
                           [g.normal(size=(2, 3)),
                            g.uniform(size=(2, 1))], axis=-1)),
    "HoverAviary": (dict(), lambda env, g: g.uniform(-1, 1, size=(1, 4))),
    "MultiHoverAviary": (dict(num_drones=2),
                         lambda env, g: g.uniform(-1, 1, size=(2, 4))),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread_agg():
    """Small tensors: one intra-op thread; matplotlib draws off screen."""
    import matplotlib
    matplotlib.use("Agg")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name, **kw):
    args, _ = CASES.get(name, ({}, None))
    args = {**args, **kw}
    return (getattr(jad, name)(physics=JE.Physics.DYN, **args),
            getattr(tad, name)(physics=TE.Physics.DYN, device="cpu", **args))


@pytest.mark.parametrize("name", list(CASES))
def test_aviary_matches_jax(name):
    jenv, tenv = _pair(name)
    for js, ts in ((jenv.action_space, tenv.action_space),
                   (jenv.observation_space, tenv.observation_space)):
        assert ts.shape == js.shape and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)
        assert ts.contains(ts.sample())
    for k in ("NUM_DRONES", "CTRL_FREQ", "PYB_FREQ", "CTRL_TIMESTEP",
              "PYB_TIMESTEP", "MAX_RPM", "HOVER_RPM"):
        assert getattr(tenv, k) == pytest.approx(getattr(jenv, k), rel=1e-6)
    for k in ("INIT_XYZS", "INIT_RPYS", "TARGET_POS"):
        if hasattr(jenv, k):
            np.testing.assert_allclose(getattr(tenv, k), getattr(jenv, k),
                                       atol=1e-6)
    jobs, _ = jenv.reset(seed=1)
    tobs, _ = tenv.reset(seed=1)
    assert tobs.shape == jobs.shape and tobs.dtype == np.float32
    np.testing.assert_allclose(tobs, jobs, rtol=RTOL, atol=ATOL)
    atol = PID_ATOL if name == "VelocityAviary" else ATOL
    g = np.random.default_rng(4)
    act_of = CASES[name][1]
    for t in range(8):
        # re-anchored: the port steps from the JAX adapter's state
        tenv.state = convert.env_state_from_numpy(jenv.state._asdict(),
                                                  device="cpu")
        a = act_of(jenv, g).astype(np.float32)
        jo, jr, jte, jtr, _ = jenv.step(a)
        to, tr, tte, ttr, _ = tenv.step(a)
        np.testing.assert_allclose(to, jo, rtol=RTOL, atol=atol,
                                   err_msg=f"obs t={t}")
        assert isinstance(tr, float) and tr == pytest.approx(jr, abs=atol)
        assert (tte, ttr) == (bool(jte), bool(jtr))
    for d in range(tenv.NUM_DRONES):
        np.testing.assert_allclose(tenv.getDroneStateVector(d),
                                   jenv.getDroneStateVector(d), rtol=RTOL,
                                   atol=atol)
    np.testing.assert_array_equal(tenv.getAdjacencyMatrix(),
                                  jenv.getAdjacencyMatrix())
    assert tenv.getPyBulletClient() is None
    np.testing.assert_array_equal(tenv.getDroneIds(), jenv.getDroneIds())


def test_adjacency_matrix_adapter():
    """tests/test_adapter_api.py's case, on both adapters."""
    xyz = np.array([[0, 0, 1], [0.3, 0, 1], [5, 5, 1]])
    jenv, tenv = _pair("CtrlAviary", num_drones=3, neighbourhood_radius=0.5,
                       initial_xyzs=xyz)
    jenv.reset()
    tenv.reset()
    adj = tenv.getAdjacencyMatrix()
    assert adj.shape == (3, 3)
    assert adj[0, 1] == 1 and adj[1, 0] == 1   # within 0.5 m
    assert adj[0, 2] == 0 and adj[1, 2] == 0   # far away
    assert np.all(np.diag(adj) == 1)
    np.testing.assert_array_equal(adj, jenv.getAdjacencyMatrix())


def test_drone_images_match_jax_and_export(tmp_path):
    """Each drone's camera (rgba, depth, seg) against the JAX adapter's,
    held by the tie-aware comparison of ops/render_check.py; drone 0 sees
    drone 1 ahead; the captures export as PNG."""
    xyz = np.array([[0, 0, 0.3], [0.8, 0, 0.3]])
    jenv, tenv = _pair("CtrlAviary", initial_xyzs=xyz)
    jenv.reset()
    tenv.reset()
    got = [tenv.getDroneImages(d) for d in range(2)]
    ref = [jenv.getDroneImages(d) for d in range(2)]
    assert got[0][0].shape == (48, 64, 4) and got[0][1].shape == (48, 64)
    assert got[0][2].dtype == np.int32
    assert (got[0][2] == 101).any()      # sees drone 1 ahead
    pos = np.asarray(jenv.state.pos)
    fwd = np.asarray(jquat.quat_to_mat(jenv.state.quat))[:, :, 0]
    stack = lambda imgs: tuple(np.stack([im[k] for im in imgs])
                               for k in range(3))
    assert_render_close(stack(got), stack(ref), pos, fwd,
                        tenv.cfg.drone.l)
    from gym_pybullet_drones_tpu_torch.utils.enums import ImageType
    rgb, dep, seg = got[0]
    outs = [tenv.exportImage(rgb, str(tmp_path), 0),
            tenv.exportImage(dep, str(tmp_path), 1, ImageType.DEP),
            tenv.exportImage(seg, str(tmp_path), 2, ImageType.SEG),
            tenv.exportImage(rgb, str(tmp_path), 3, ImageType.BW)]
    assert all(os.path.getsize(p) > 0 for p in outs)


def test_user_debug_gui_rpm_override():
    """tests/test_viewer.py's slider case on the port's CtrlAviary (PYB):
    pressing "Use GUI RPM" toggles USE_GUI_RPM; while on, the four slider
    RPMs override the action through `core.step(rpm_override=...)`, tiled
    over drones; pressing again hands control back."""
    env = tad.CtrlAviary(num_drones=2, gui=True, user_debug_gui=True,
                         pyb_freq=240, ctrl_freq=48, device="cpu")
    env.reset()
    env.step(np.zeros((2, 4)))
    v = env._viewer
    assert v.user_debug and len(v._sliders) == 4
    np.testing.assert_allclose(v.slider_values(), env.HOVER_RPM, rtol=1e-6)
    assert len(v._axes_lines) == env.NUM_DRONES

    v.press_input_switch()
    for i in range(4):
        v.set_slider(i, 1.05 * env.HOVER_RPM)
    for _ in range(48):
        obs, *_ = env.step(np.zeros((2, 4)))  # zero action ignored
    assert env.USE_GUI_RPM
    assert obs[0, 2] > 0.3          # climbed under slider RPM
    np.testing.assert_allclose(env.gui_input, 1.05 * env.HOVER_RPM,
                               rtol=1e-6)
    np.testing.assert_allclose(obs[:, 16:20], 1.05 * env.HOVER_RPM,
                               rtol=1e-6)

    v.press_input_switch()          # toggle back off
    for _ in range(24):
        obs, *_ = env.step(np.zeros((2, 4)))
    assert not env.USE_GUI_RPM
    assert obs[0, 2] < 0.1          # zero-RPM action in effect again
    assert len(v._frames) == 1 + 48 + 24
    env.close()


def test_record_and_device_default(tmp_path, monkeypatch):
    """Recording writes ray-traced frames and assembles them into a video
    at close; the adapters' device=None is the card, which raises without
    one."""
    # HoverAviary takes no output_folder (as the JAX adapter's): it
    # records under ./results
    monkeypatch.chdir(tmp_path)
    env = tad.HoverAviary(physics=TE.Physics.DYN, record=True, device="cpu")
    env.reset()
    for _ in range(6):                 # counters 0..40: frames at 0 and 40
        env.step(np.zeros((1, 4), np.float32))
    env.close()
    assert os.path.dirname(env._record_dir) == "results"
    files = sorted(os.listdir(env._record_dir))
    assert files == ["frame_0.png", "frame_1.png", "video.avi"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tad.CtrlAviary(),
                 lambda: tad.BatchedEnv(env.cfg, env.task, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
