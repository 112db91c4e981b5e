"""The port's ray tracer (gym_pybullet_drones_tpu_torch/ops/render.py, the
plain version of the render kernel) against the JAX package's
`ops/render.py`, on the CPU.

The same cameras go through both: the fixed poses of tests/test_render.py
and 64 seeded cameras (32 envs of 2 drones that see each other, some
pitched down over negative x and y, where the checkerboard's floored modulo
matters).  rgba, depth and seg are held at the tolerances of
tests/_torch_helpers.py (`assert_render_close`); the shading oracle of
tests/test_render.py:84 is recomputed here in NumPy for the port.  The JAX
scene is built in float32 and every input is cast: the suite runs JAX in
x64.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as JP
from gym_pybullet_drones_tpu.ops import quat as jquat, render as jrender

from gym_pybullet_drones_tpu_torch import params as TP
from gym_pybullet_drones_tpu_torch.ops import (
    kernel_render, quat as tquat, render as trender, render_check)

from tests._torch_helpers import assert_render_close

SCENES = ("landmark", "empty")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors, and the suite runs files side by side: one intra-op
    thread runs them faster than a pool that must be woken for each op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cam(pos, rpy):
    """float32 (pos, quat, rot) of cameras at `pos` with attitude `rpy`."""
    pos = np.array(pos, np.float32)
    q = np.array(jquat.rpy_to_quat(jnp.asarray(rpy, jnp.float32)),
                 np.float32)
    rot = np.array(jquat.quat_to_mat(jnp.asarray(q)), np.float32)
    return pos, q, rot


def _both(scene, pos, rot, drone_pos=None):
    """(port, JAX) (rgba, depth, seg) of the same cameras, as numpy."""
    js = getattr(jrender, f"{scene}_scene")(jnp.float32)
    ts = getattr(trender, f"{scene}_scene")()
    jd = None if drone_pos is None else jnp.asarray(drone_pos)
    td = None if drone_pos is None else torch.from_numpy(drone_pos)
    j = jrender.render(JP.CF2X, js, jnp.asarray(pos), jnp.asarray(rot),
                       drone_pos=jd)
    t = trender.render(TP.CF2X, ts, torch.from_numpy(pos),
                       torch.from_numpy(rot), drone_pos=td)
    return tuple(x.numpy() for x in t), tuple(np.asarray(x) for x in j)


def _seeded_cameras(seed=0, envs=32, n=2):
    """`envs` x `n` drone cameras over the arena: roll small, pitch from
    level to steeply down, any yaw; the first quarter pitched down over
    negative x and y."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-1.5, -1.5, 0.05], [1.5, 1.5, 1.5], size=(envs, n, 3))
    rpy = np.stack([rng.normal(0, 0.2, (envs, n)),
                    rng.uniform(-0.4, 1.2, (envs, n)),
                    rng.uniform(-np.pi, np.pi, (envs, n))], axis=-1)
    q = envs // 4
    pos[:q, :, :2] = rng.uniform(-1.5, -0.2, size=(q, n, 2))
    rpy[:q, :, 1] = rng.uniform(0.5, 1.3, size=(q, n))
    return _cam(pos, rpy)


@pytest.mark.parametrize("scene", SCENES)
def test_seeded_cameras_match_jax(scene):
    pos, q, rot = _seeded_cameras()
    got, ref = _both(scene, pos, rot, drone_pos=pos[:, None])
    assert got[0].shape == (32, 2, 48, 64, 4)
    ties = assert_render_close(got, ref, pos, rot[..., :, 0], TP.CF2X.l)
    seen = set(np.unique(ref[2]).tolist())
    assert {100, 101} <= seen
    if scene == "landmark":
        assert {1, 2, 3, 4} <= seen
    # the checkerboard over negative coordinates: both greys are there
    ground = got[0][..., 0][ref[2] == 0]
    assert len(np.unique(np.round(ground))) >= 2
    assert ties["seg_differ"] + ties["checker_ties"] <= 0.001 * ref[2].size


def test_kernel_plain_version_matches_render():
    """The render kernel's plain version (cameras at the drones of a flat
    batch, posed by their quaternions) is `render` of those cameras; the
    view direction it builds is the rotation's first column."""
    pos, q, rot = _seeded_cameras(seed=1, envs=8, n=4)
    fwd = trender.camera_forward(torch.from_numpy(q))
    np.testing.assert_allclose(
        fwd.numpy(), tquat.quat_to_mat(torch.from_numpy(q))[..., :, 0],
        rtol=0, atol=1e-6)
    flat_pos = torch.from_numpy(pos.reshape(32, 3))
    flat_q = torch.from_numpy(q.reshape(32, 4))
    rgba, depth, seg = kernel_render.render_drones(
        TP.CF2X, trender.landmark_scene(), flat_pos, flat_q, 4,
        depth_seg=True)
    assert rgba.shape == (32, 48 * 64 * 4) and seg.dtype == torch.int32
    assert torch.equal(kernel_render.render_drones(
        TP.CF2X, trender.landmark_scene(), flat_pos, flat_q, 4), rgba)
    got = (rgba.reshape(8, 4, 48, 64, 4), depth.reshape(8, 4, 48, 64),
           seg.reshape(8, 4, 48, 64))
    ref = trender.render(TP.CF2X, trender.landmark_scene(),
                         torch.from_numpy(pos), torch.from_numpy(rot),
                         drone_pos=torch.from_numpy(pos)[:, None])
    assert_render_close(got, ref, pos, rot[..., :, 0], TP.CF2X.l)
    with pytest.raises(ValueError, match="envs of 3"):
        kernel_render.render_drones(TP.CF2X, trender.empty_scene(),
                                    flat_pos, flat_q, 3)


def test_fixed_poses_match_jax_and_test_render():
    """tests/test_render.py's poses: background, landmark, depth, other
    drones, each property held on the port and the images on the JAX
    package's."""
    # horizontal view from z = 1: sky above, floor below
    pos, _, rot = _cam([0, 0, 1.0], [0, 0, 0])
    got, ref = _both("landmark", pos, rot)
    assert_render_close(got, ref, pos, rot[:, 0], TP.CF2X.l)
    rgba, dep, seg = got
    assert rgba.shape == (48, 64, 4) and dep.shape == seg.shape == (48, 64)
    assert (seg[:10] == -1).mean() > 0.8 and (seg[-10:] == 0).mean() > 0.8
    assert np.all(rgba[..., 3] == 255)
    # the red block ahead, centred, red-dominant, nearer than far
    pos, _, rot = _cam([0, 0, 0.1], [0, 0, 0])
    got, ref = _both("landmark", pos, rot)
    assert_render_close(got, ref, pos, rot[:, 0], TP.CF2X.l)
    rgba, dep, seg = got
    ys, xs = np.where(seg == 1)
    assert len(xs) and abs(xs.mean() - 32) < 8
    px = rgba[seg == 1]
    assert (px[:, 0] > px[:, 2]).mean() > 0.9
    assert dep[seg == 1].max() < 0.99999
    assert np.allclose(dep[seg == -1], dep[seg == -1].max())
    # another drone straight ahead
    pos, _, rot = _cam([0, 0, 0.5], [0, 0, 0])
    others = np.asarray([[0.5, 0.0, 0.5]], np.float32)
    got, ref = _both("empty", pos, rot, drone_pos=others)
    assert_render_close(got, ref, pos, rot[:, 0], TP.CF2X.l)
    assert (got[2] == 100).any()
    # a drone within 3L of the camera is not drawn: its own body
    got, _ = _both("empty", pos, rot, drone_pos=pos[None])
    assert not (got[2] >= 100).any()


def test_tinyrenderer_shading_per_object_rgb():
    """tests/test_render.py:84's oracle, recomputed in NumPy from the port's
    constants: colour = base * (AMBIENT + DIFFUSE * max(0, N.L))."""
    scene = trender.landmark_scene()
    a, d = trender.AMBIENT, trender.DIFFUSE
    light = np.asarray(trender.LIGHT_DIR, np.float64)
    light /= np.linalg.norm(light)
    pos, _, rot = _cam([0.3, 0.0, 0.1], [0, 0, 0])
    (rgba, _, seg), _ = _both("landmark", pos, rot)
    block = rgba[seg == 1][:, :3]
    assert block.shape[0] > 20
    np.testing.assert_allclose(
        block.mean(axis=0),
        np.clip(np.asarray(scene.box_color[0]) * a * 255.0, 0, 255),
        atol=1.0)
    assert np.ptp(block, axis=0).max() <= 1.0
    ground = rgba[seg == 0][:, 0].astype(np.float64)
    shade = a + d * light[2]
    hi_exp, lo_exp = 0.75 * shade * 255.0, 0.55 * shade * 255.0
    hi = ground[np.abs(ground - hi_exp) < np.abs(ground - lo_exp)]
    lo = ground[np.abs(ground - hi_exp) >= np.abs(ground - lo_exp)]
    assert ground.size > 100 and hi.size and lo.size
    np.testing.assert_allclose(hi, hi_exp, atol=1.0)
    np.testing.assert_allclose(lo, lo_exp, atol=1.0)
    pos, _, rot = _cam([-0.7, 0.0, 0.1], [0, 0, np.pi])
    (rgba, _, seg), _ = _both("landmark", pos, rot)
    duck = rgba[seg == 3][:, :3].astype(np.float64)
    assert duck.shape[0] > 10
    ratio = duck / (np.asarray(scene.sphere_color[0]) * 255.0)
    assert np.abs(ratio - ratio[:, :1]).max() < 0.02
    assert ratio.min() >= a - 0.02 and ratio.max() <= a + d + 0.02


def test_checker_uses_the_floored_modulo():
    """Tiles whose index sum is negative take the same greys as the JAX
    package's `%`: a camera looking straight down over (-0.5, -0.5) sees
    the four tiles around the origin, two of each grey."""
    pos, _, rot = _cam([[0.0, 0.0, 0.6]], [[0.0, np.pi / 2 - 1e-3, 0.0]])
    got, ref = _both("empty", pos, rot)
    assert_render_close(got, ref, pos, rot[..., :, 0], TP.CF2X.l)
    greys = np.unique(np.round(got[0][0][..., 0][got[2][0] == 0]))
    assert len(greys) == 2


@pytest.mark.parametrize("fault", ["none", "tile_grey", "box_normal",
                                   "seg", "depth"])
def test_render_check_catches_whole_faults(fault):
    """`render_check.compare_render`, which both these tests and the
    card's checks use, passes a render held against itself and refuses
    the faults its tie allowance must not hide: every ground tile of one
    grey painted the other (a truncated modulo), a box face shaded as its
    opposite (a flipped normal), an object's pixels given another id, a
    depth shifted past DEPTH_ATOL."""
    pos, _, rot = _seeded_cameras(seed=2, envs=8, n=2)
    ref, _ = _both("landmark", pos, rot, drone_pos=pos[:, None])
    rgba, depth, seg = (torch.from_numpy(x) for x in ref)
    got = [rgba.clone(), depth.clone(), seg.clone()]
    grey = rgba[..., 0]
    if fault == "tile_grey":
        lo = (seg == 0) & (grey < grey[seg == 0].max() - 5.0)
        got[0][lo] = rgba[(seg == 0) & ~lo][0]
    elif fault == "box_normal":
        face = seg == 1
        got[0][face] = torch.cat([rgba[face][:, :3] * 0.5,
                                  rgba[face][:, 3:]], dim=-1)
    elif fault == "seg":
        got[2][seg == 3] = 4
    elif fault == "depth":
        got[1][seg == 0] += 3 * render_check.DEPTH_ATOL
    args = (got, (rgba, depth, seg), torch.from_numpy(pos),
            torch.from_numpy(rot[..., :, 0]), TP.CF2X.l)
    if fault == "none":
        rec = render_check.compare_render("same", *args)
        assert rec["bitwise_equal"] and rec["tie_share"] == 0.0
        return
    assert (seg == {"tile_grey": 0, "box_normal": 1, "seg": 3,
                    "depth": 0}[fault]).any()
    with pytest.raises(AssertionError, match="fault"):
        render_check.compare_render("fault", *args)
