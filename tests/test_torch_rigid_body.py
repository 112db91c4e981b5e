"""Port ops/rigid_body.py against the JAX package's: `pyb_step` in float64
(1e-12 on unit-scale values) and float32 over a free flight, a drop onto the
ground until rest, a tilted landing and a sphere and a box obstacle hit (the
set-ups of tests/test_pallas.py:295-378), with 4 and 50 solver sweeps;
`resolve_drone_collisions` for head-on, glancing and height-offset pairs.

float32 tolerance: 2e-5 absolute / 1e-4 relative on positions, attitude and
velocity; the angular velocity, which a contact impulse reaches through 1/J
(7e4), 5e-4 / 3e-4 (the JAX package's own between its two PYB paths,
tests/test_pallas.py:241-259)."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.ops import rigid_body as jrb, quat as jq
from gym_pybullet_drones_tpu_torch.ops import rigid_body as trb

from tests._torch_helpers import models

DT = 1 / 240
SPHERE = ((0.0, 2.0, 0.5, 0.1),)
BOX = ((0.0, 2.5, 0.5, 0.5, 0.5, 0.5),)


def _scenario(name, hover):
    """(pos, rpy, vel, ang_v, rpm, obstacles, steps) of one drone, (1, k)."""
    z = lambda *v: np.asarray([v], np.float64)
    if name == "free_flight":
        return (z(0, 0, 1), z(0.1, -0.2, 0.3), z(0.3, -0.1, 0.2),
                z(0.5, -1.0, 2.0), hover * np.asarray(
                    [[1.02, 0.97, 1.01, 1.0]]), (), 40)
    if name == "drop_to_rest":
        return (z(0, 0, 0.08), z(0, 0, 0), z(0, 0, 0), z(0, 0, 0),
                np.zeros((1, 4)), (), 90)
    if name == "tilted_landing":
        return (z(0, 0, 0.06), z(0.35, -0.2, 0.4), z(0.4, 0.0, -0.5),
                z(0, 0, 0), 0.5 * hover * np.ones((1, 4)), (), 90)
    obstacles = SPHERE if name == "sphere_hit" else BOX
    return (z(0, 1.82, 0.5), z(0, 0, 0), z(0, 1.5, 0), z(0, 0, 0),
            hover * np.ones((1, 4)), obstacles, 40)


SCENARIOS = ("free_flight", "drop_to_rest", "tilted_landing", "sphere_hit",
             "box_hit")
_JAX_STEPS = {}


def _jax_step(jm, obstacles, sweeps):
    """The jitted JAX `pyb_step`, the rpm an argument: one compile for
    each (obstacles, sweeps, dtype), shared by the scenarios."""
    key = (obstacles, sweeps)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = jax.jit(lambda s, rpm: jrb.pyb_step(
            jm, s, rpm, DT, obstacles=obstacles, solver_iterations=sweeps))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sweeps", [4, 50])
@pytest.mark.parametrize("name", SCENARIOS)
def test_pyb_step_matches_jax(name, sweeps, dtype):
    jm, tm = models("cf2x")
    pos, rpy, vel, ang_v, rpm, obstacles, steps = _scenario(name,
                                                            jm.hover_rpm)
    quat = np.asarray(jq.rpy_to_quat(jnp.asarray(rpy)))
    js = jrb.PybState(*(jnp.asarray(a, dtype) for a in (pos, quat, vel,
                                                        ang_v)))
    ts = trb.PybState(*(torch.from_numpy(np.asarray(a, dtype))
                        for a in (pos, quat, vel, ang_v)))
    j_step = _jax_step(jm, obstacles, sweeps)
    j_rpm = jnp.asarray(rpm, dtype)
    t_rpm = torch.from_numpy(np.asarray(rpm, dtype))
    touched = False
    for t in range(steps):
        js = j_step(js, j_rpm)
        ts = trb.pyb_step(tm, ts, t_rpm, DT, obstacles=obstacles,
                          solver_iterations=sweeps)
        for k in ("pos", "quat", "vel", "ang_v"):
            got, ref = getattr(ts, k).numpy(), np.asarray(getattr(js, k))
            assert got.dtype == dtype and ref.dtype == dtype
            if dtype == np.float64:
                tol = dict(rtol=1e-12, atol=1e-12)
            elif k == "ang_v":
                tol = dict(rtol=3e-4, atol=5e-4)
            else:
                tol = dict(rtol=1e-4, atol=2e-5)
            np.testing.assert_allclose(got, ref, err_msg=f"{k} t={t}", **tol)
        touched |= float(ts.pos[0, 2]) < 0.0125 + 0.02
    p = ts.pos[0].tolist()
    if name == "free_flight":
        assert not touched
    elif name == "drop_to_rest":
        # at rest on the bottom of the collision cylinder
        assert abs(p[2] - 0.0125) < 2e-3 and abs(float(ts.vel[0, 2])) < 1e-3
    elif name == "tilted_landing":
        # the rim's lever arms right the drone
        rp = np.asarray(jq.quat_to_rpy(jnp.asarray(ts.quat.numpy())))[0, :2]
        assert touched and np.abs(rp).max() < 0.05
    elif name == "sphere_hit":
        assert p[1] < 2.0 - 0.1 - tm.collision_r + 2e-3    # stopped outside
    else:
        assert p[1] <= 2.0 - tm.collision_r + 2e-3         # at the -y face


def test_hover_on_the_ground_stays_level():
    """A symmetric hover resting on the ground, float32, 1 s: equal rpm
    give exactly zero body torque (factored differences), but the
    sequential contact sweeps visit the four rim points one after the other
    and leave a drift of some 0.1 mm/s and a yaw rate of 1e-3 rad/s, in
    both packages alike: level and in place to a margin, not bitwise."""
    jm, tm = models("cf2x")
    rpm = np.full((1, 4), 0.5 * jm.hover_rpm, np.float32)
    start = (np.asarray([[0, 0, 0.0125]], np.float32),
             np.asarray([[0, 0, 0, 1]], np.float32),
             np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32))
    js = jrb.PybState(*(jnp.asarray(a) for a in start))
    ts = trb.PybState(*(torch.from_numpy(a) for a in start))
    j_step, j_rpm = _jax_step(jm, (), jrb.SOLVER_ITERATIONS), jnp.asarray(rpm)
    for _ in range(240):
        js = j_step(js, j_rpm)
        ts = trb.pyb_step(tm, ts, torch.from_numpy(rpm), DT)
    np.testing.assert_allclose(ts.pos.numpy(), np.asarray(js.pos), atol=2e-5)
    np.testing.assert_allclose(ts.quat.numpy(), np.asarray(js.quat),
                               atol=2e-5)
    assert np.abs(ts.pos.numpy()[0, :2]).max() < 1e-3
    assert np.abs(ts.quat.numpy()[0, :2]).max() < 1e-3
    assert abs(float(ts.pos[0, 2]) - 0.0125) < 1e-4
    # the body torque itself is exactly zero for equal rpm
    for coefs in ([o[1] for o in tm.prop_offsets],
                  [-o[0] for o in tm.prop_offsets]):
        assert not trb._paired_prop_torque(tm, torch.from_numpy(rpm), coefs) \
            .any()


def _pair_case(name, n):
    """(pos, rpy, vel, ang_v) of n drones, drones 0 and 1 in contact."""
    rng = np.random.default_rng(5)
    pos = np.zeros((n, 3))
    pos[:, 0] = 1.0 * np.arange(n)
    pos[:, 2] = 1.0
    rpy = np.zeros((n, 3))
    vel = np.zeros((n, 3))
    ang_v = np.zeros((n, 3))
    if name == "head_on":
        pos[1] = [0.11, 0, 1.0]
        vel[0], vel[1] = [0.5, 0, 0], [-0.5, 0, 0]
    elif name == "glancing":
        pos[1] = [0.09, 0.06, 1.0]
        vel[0], vel[1] = [0.6, 0.1, 0], [-0.3, 0, 0.1]
        ang_v[0] = [0, 0, 3.0]
    else:  # height_offset: tilted, one above the other's rim
        pos[1] = [0.08, 0.0, 1.02]
        rpy[0], rpy[1] = [0.3, 0, 0], [0, -0.4, 0.5]
        vel[0], vel[1] = [0.4, 0, 0.2], [-0.4, 0, -0.2]
        ang_v[:] = rng.normal(size=(n, 3))
    return pos, rpy, vel, ang_v


@functools.lru_cache(maxsize=None)
def _jax_resolve(oriented):
    """The jitted JAX `resolve_drone_collisions` (one compile for each
    shape and dtype, shared by the cases), with the drones' orientation
    or the legacy centred response."""
    jm = models("cf2x")[0]
    if oriented:
        return jax.jit(lambda p, v, q, w: jrb.resolve_drone_collisions(
            jm, p, v, DT, quat=q, ang_v=w))
    return jax.jit(lambda p, v: jrb.resolve_drone_collisions(jm, p, v, DT))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["head_on", "glancing", "height_offset"])
def test_resolve_drone_collisions_matches_jax(name, n, dtype):
    jm, tm = models("cf2x")
    pos, rpy, vel, ang_v = _pair_case(name, n)
    quat = np.asarray(jq.rpy_to_quat(jnp.asarray(rpy)))
    a = [np.asarray(x, dtype) for x in (pos, vel, quat, ang_v)]
    jp, jv, jw = _jax_resolve(True)(*(jnp.asarray(x) for x in a))
    tp, tv, tw = trb.resolve_drone_collisions(
        tm, torch.from_numpy(a[0]), torch.from_numpy(a[1]), DT,
        quat=torch.from_numpy(a[2]), ang_v=torch.from_numpy(a[3]))
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 \
        else dict(rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(tp.numpy(), a[0])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(
        tw.numpy(), np.asarray(jw),
        **(tol if dtype == np.float64 else dict(rtol=3e-4, atol=5e-4)))
    # the pair was hit, the others were not; linear momentum is conserved
    # (equal masses: the velocity changes cancel)
    dv = tv.numpy() - a[1]
    assert np.abs(dv[0]).max() > 1e-3 and not dv[2:].any()
    np.testing.assert_allclose(dv.sum(axis=0), 0.0,
                               atol=1e-12 if dtype == np.float64 else 1e-6)
    if name == "head_on":
        assert not np.abs(tw.numpy() - a[3]).max() > 1e-6   # no spin
    else:
        assert np.abs(tw.numpy() - a[3]).max() > 1e-2       # it tumbles
    # the legacy centred response (no orientation given)
    jl = _jax_resolve(False)(jnp.asarray(a[0]), jnp.asarray(a[1]))
    tl = trb.resolve_drone_collisions(tm, torch.from_numpy(a[0]),
                                      torch.from_numpy(a[1]), DT)
    assert len(tl) == 2
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]), **tol)


def test_batched_leading_dims_and_lone_drone():
    """Leading batch dims written out: (B, N, k) in one call equals B calls;
    a lone drone comes back untouched."""
    _, tm = models("cf2x")
    cases = [_pair_case(nm, 3) for nm in ("head_on", "glancing",
                                          "height_offset")]
    t = lambda i: torch.from_numpy(np.stack([c[i] for c in cases])
                                   .astype(np.float32))
    from gym_pybullet_drones_tpu_torch.ops import quat as tq
    pos, vel, ang_v = t(0), t(2), t(3)
    quat = tq.rpy_to_quat(t(1))
    _, bv, bw = trb.resolve_drone_collisions(tm, pos, vel, DT, quat=quat,
                                             ang_v=ang_v)
    for i in range(3):
        _, v, w = trb.resolve_drone_collisions(tm, pos[i], vel[i], DT,
                                               quat=quat[i], ang_v=ang_v[i])
        np.testing.assert_allclose(bv[i].numpy(), v.numpy(), atol=1e-7)
        np.testing.assert_allclose(bw[i].numpy(), w.numpy(), atol=1e-5)
    one = trb.resolve_drone_collisions(tm, pos[0, :1], vel[0, :1], DT,
                                       quat=quat[0, :1], ang_v=ang_v[0, :1])
    assert one[1] is vel[0, :1] or torch.equal(one[1], vel[0, :1])
    assert trb._prop_coef_pairs([0.0, 0.04, 0.0, -0.04]) == (
        [(1, 3, 0.04)], [])
    assert trb._prop_coef_pairs([0.1, 0.2, 0.0, 0.0]) == ([], [0, 1])
