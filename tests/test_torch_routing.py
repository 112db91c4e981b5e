"""Port envs/routing.py, and the small helpers of envs/core.py that came with
it, against the JAX package's: `next_waypoint`, `adjacency_matrix`,
`normalized_action_to_rpm`, every RoutingTask hook on seeded states (the
per-env methods, the flat hooks of the batched path and the row hooks the
fused kernel's plain version calls), and both rollout entry points for a
fleet of three on DYN physics against the JAX package's XLA batched path.

Tolerances: the hooks are short float32 formulas, 1e-6 absolute on unit-scale
values (reward, with its gain of 10 and exp, 2e-5); the rollouts use the JAX
package's own for the embedded-PID paths, tests/test_fused.py:83-102: 5e-5
absolute and 1e-4 relative on observations and reward, flags equal."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import core as jcore, fast as jfast
from gym_pybullet_drones_tpu_torch.envs import core as tcore, fast as tfast
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import PID_ATOL, RTOL, rand_dyn, routing_pair

N, B = 3, 4


def _fleet_state(jcfg, jtask, tcfg, ttask, b, seed):
    """One seeded batched EnvState for both packages: drones scattered
    around the line between start and goal; env 0 has every drone inside
    `arrival_tol` of its destination, env 1 has drones 0 and 1 closer than
    the collision radius, env 2 is past the episode's end."""
    rng = np.random.default_rng(seed)
    n = jcfg.num_drones
    pos, quat, vel, rates, ang_v = (a.reshape(b, n, -1)
                                    for a in rand_dyn(b * n, seed))
    pos = pos + np.asarray(jcfg.init_xyzs, np.float32)[None]
    dest = np.asarray(jtask.destinations, np.float32)
    pos[0] = dest + 0.01 * rng.normal(size=(n, 3)).astype(np.float32)
    pos[1, 1] = pos[1, 0] + np.float32(0.05)
    counter = np.zeros((b,), np.int32)
    counter[2] = 3848
    js1, _, _ = jcore.reset(jcfg, jtask)
    ts1, _, _ = tcore.reset(tcfg, ttask, device="cpu")
    js = jax.tree.map(lambda x: jnp.stack([x] * b), js1)._replace(
        pos=jnp.asarray(pos), quat=jnp.asarray(quat), vel=jnp.asarray(vel),
        rpy_rates=jnp.asarray(rates), ang_v=jnp.asarray(ang_v),
        step_counter=jnp.asarray(counter))
    t = torch.from_numpy
    ts = tcore.map_leaves(lambda x: torch.stack([x] * b), ts1)._replace(
        pos=t(pos), quat=t(quat), vel=t(vel), rpy_rates=t(rates),
        ang_v=t(ang_v), step_counter=t(counter))
    return js, ts


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_next_waypoint_matches_jax(dtype):
    rng = np.random.default_rng(1)
    cur = rng.normal(size=(16, 3)).astype(dtype)
    dest = cur + rng.normal(size=(16, 3)).astype(dtype) \
        * np.geomspace(0.05, 20, 16).astype(dtype)[:, None]
    dest[0] = cur[0]                               # zero distance
    dest[1] = cur[1] + np.asarray([0.5, 0, 0], dtype)  # exactly step_size
    for step in (1.0, 0.5):
        ref = np.asarray(jcore.next_waypoint(jnp.asarray(cur),
                                             jnp.asarray(dest), step))
        out = tcore.next_waypoint(torch.from_numpy(cur),
                                  torch.from_numpy(dest), step)
        assert out.numpy().dtype == dtype and ref.dtype == dtype
        np.testing.assert_allclose(
            out.numpy(), ref, rtol=0,
            atol=1e-12 if dtype == np.float64 else 2e-6)
    np.testing.assert_array_equal(out.numpy()[0], cur[0])
    np.testing.assert_array_equal(out.numpy()[1], dest[1])


def test_adjacency_and_normalized_rpm_match_jax():
    (jcfg, jtask), (tcfg, ttask) = routing_pair(N)
    js, ts = _fleet_state(jcfg, jtask, tcfg, ttask, B, seed=2)
    ref = jax.vmap(lambda s: jcore.adjacency_matrix(jcfg, s))(js)
    out = tcore.adjacency_matrix(tcfg, ts)
    assert out.shape == (B, N, N) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < float(out.sum()) - B * N < B * N * (N - 1)  # both answers
    a = np.linspace(-1.3, 1.3, 27, dtype=np.float32).reshape(9, 3)
    np.testing.assert_allclose(
        tcore.normalized_action_to_rpm(tcfg, torch.from_numpy(a)).numpy(),
        np.asarray(jcore.normalized_action_to_rpm(jcfg, jnp.asarray(a))),
        rtol=1e-6)


@pytest.mark.parametrize("shaped", [True, False])
def test_routing_task_methods_match_jax(shaped):
    """compute_obs / reward / terminated / truncated of one env, batched
    here and vmapped there, with an arrival, a close pair and a timeout."""
    (jcfg, jtask), (tcfg, ttask) = routing_pair(N, shaped=shaped)
    js, ts = _fleet_state(jcfg, jtask, tcfg, ttask, B, seed=3)
    jv = lambda f: np.asarray(jax.vmap(lambda s: f(jcfg, s))(js))
    obs = ttask.compute_obs(tcfg, ts)
    assert obs.shape == (B, N, 63) == (B, N, ttask.obs_dim(tcfg))
    np.testing.assert_allclose(obs.numpy(), jv(jtask.compute_obs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ttask.compute_reward(tcfg, ts).numpy(),
                               jv(jtask.compute_reward), rtol=RTOL, atol=2e-5)
    term = ttask.compute_terminated(tcfg, ts)
    trunc = ttask.compute_truncated(tcfg, ts)
    assert term.tolist() == jv(jtask.compute_terminated).tolist() \
        == [True, False, False, False]
    assert trunc.tolist() == jv(jtask.compute_truncated).tolist()
    assert trunc[2]
    # the close pair of env 1 is counted once in each order
    assert float(ttask._penalty(ts.pos)[1]) >= 2.0


def _drones(pos, rpy, vel):
    """(B, N, 3) arrays -> the row hooks' per-drone dicts of (B,) rows."""
    return [{"p": [pos[:, i, k] for k in range(3)],
             "rpy": tuple(rpy[:, i, k] for k in range(3)),
             "v": [vel[:, i, k] for k in range(3)],
             "w": [vel[:, i, k] * 0 for k in range(3)]}
            for i in range(pos.shape[1])]


@pytest.mark.parametrize("shaped", [True, False])
def test_flat_and_row_hooks_match_jax(shaped):
    """The batched path's flat hooks and the fused kernel's row hooks give
    the JAX package's answers and each other's, nearest-neighbour ties
    included: the reset line has equal spacing, so the inner drone has two
    neighbours at exactly the same distance."""
    from gym_pybullet_drones_tpu.ops import quat as jq
    from gym_pybullet_drones_tpu_torch.ops import quat as tq
    (jcfg, jtask), (tcfg, ttask) = routing_pair(N, shaped=shaped)
    js, ts = _fleet_state(jcfg, jtask, tcfg, ttask, B, seed=4)
    line = np.asarray(jcfg.init_xyzs, np.float32)
    js = js._replace(pos=js.pos.at[3].set(jnp.asarray(line)))
    ts = ts._replace(pos=torch.cat([ts.pos[:3], torch.from_numpy(line)[None]]))
    flat = lambda s: s._replace(
        pos=s.pos.reshape(B * N, 3), quat=s.quat.reshape(B * N, 4),
        vel=s.vel.reshape(B * N, 3))
    jflat, tflat = flat(js), flat(ts)
    jrpy, trpy = jq.quat_to_rpy(jflat.quat), tq.quat_to_rpy(tflat.quat)

    jextra = np.asarray(jtask.flat_extra_obs(jcfg, jflat, B, N))
    textra = ttask.flat_extra_obs(tcfg, tflat, B, N)
    np.testing.assert_allclose(textra.numpy(), jextra, rtol=0, atol=1e-6)
    # the tie of the inner drone on the line goes to the lowest index
    np.testing.assert_array_equal(textra[3 * N + 1, 3:6].numpy(),
                                  line[0] - line[1])
    jr, jte, jtr = jtask.flat_reward_done(jcfg, jflat, jrpy, B, N)
    tr, tte, ttr = ttask.flat_reward_done(tcfg, tflat, trpy, B, N)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                               atol=2e-5)
    assert tte.tolist() == np.asarray(jte).tolist()
    assert ttr.tolist() == np.asarray(jtr).tolist()

    jd = _drones(js.pos, jrpy.reshape(B, N, 3), js.vel)
    td = _drones(ts.pos, trpy.reshape(B, N, 3), ts.vel)
    jrow = jtask.row_post(jcfg, jd, js.step_counter.astype(jnp.float32))
    trow = ttask.row_post(tcfg, td, ts.step_counter.to(torch.float32))
    np.testing.assert_allclose(trow[0].numpy(), np.asarray(jrow[0]),
                               rtol=RTOL, atol=2e-5)
    np.testing.assert_allclose(trow[0].numpy(), tr.numpy(), rtol=RTOL,
                               atol=2e-5)
    for k in (1, 2):
        assert trow[k].tolist() == np.asarray(jrow[k]).tolist() \
            == (tte, ttr)[k - 1].tolist()
    jx = jtask.row_extra_obs(jcfg, jd)
    tx = ttask.row_extra_obs(tcfg, td)
    assert len(tx) == N and all(len(rows) == 6 for rows in tx) \
        and ttask.n_extra_obs_rows == jtask.n_extra_obs_rows == 6
    rows = torch.stack([torch.stack(r, dim=-1) for r in tx], dim=1)  # (B,N,6)
    np.testing.assert_allclose(
        rows.numpy(), np.stack([np.stack(r, axis=-1) for r in jx], axis=1),
        rtol=0, atol=1e-6)
    # rows and flat columns pick the same neighbour, bit for bit
    assert torch.equal(rows.reshape(B * N, 6), textra)


def test_row_consts_and_config():
    (jcfg, jtask), (tcfg, ttask) = routing_pair(4)
    assert tcfg.init_xyzs == jcfg.init_xyzs
    assert ttask.destinations == jtask.destinations
    assert (tcfg.pyb_freq, tcfg.ctrl_freq, tcfg.neighbourhood_radius) \
        == (jcfg.pyb_freq, jcfg.ctrl_freq, jcfg.neighbourhood_radius)
    for f in dataclasses.fields(ttask):
        if f.name not in ("act", "obs"):
            assert getattr(ttask, f.name) == getattr(jtask, f.name), f.name
    assert ttask.act == TE.ActionType.PID and ttask.action_dim(tcfg) == 3
    rc = ttask.row_consts(tcfg)
    assert rc.task_id == 2 and rc.targets == ttask.destinations
    assert (rc.arrival_tol, rc.collision_radius, rc.shaped,
            rc.n_extra_obs_rows) == (0.05, 0.12, True, 6)
    # a lone drone has no neighbour: zero rows
    (_, _), (cfg1, task1) = routing_pair(1)
    s1, obs1, _ = tcore.reset(cfg1, task1, device="cpu")
    assert obs1.shape == (1, 63) and not obs1[0, 60:63].any()


@functools.lru_cache(maxsize=None)
def _jax_rollout(b, steps, scale, seed, task_kw):
    """The JAX package's XLA batched path on seeded actions, run once for
    both of the port's entry points: (reset obs, actions, per-step
    (obs, reward, term, trunc)) as numpy."""
    (jcfg, jtask), _ = routing_pair(N, **dict(task_kw))
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    js, jobs = j_reset()
    rng = np.random.default_rng(seed)
    acts = (scale * rng.normal(size=(steps, b, N, 3))).astype(np.float32)
    out = []
    for a in acts:
        js, *rest = j_step(js, jnp.asarray(a, jnp.float32))
        out.append(tuple(np.asarray(x) for x in rest))
    assert out[0][0].dtype == np.float32
    return np.asarray(jobs), acts, out


def _rollout(t_make, b, steps, scale, seed, **task_kw):
    """The port's entry point against the JAX package's XLA batched path on
    the same seeded actions; returns whether an env was reset."""
    jobs, acts, ref = _jax_rollout(b, steps, scale, seed,
                                   tuple(sorted(task_kw.items())))
    _, (tcfg, ttask) = routing_pair(N, **task_kw)
    t_reset, t_step = t_make(tcfg, ttask, b, obs_layout="flat", device="cpu")
    tc, tobs = t_reset()
    assert tobs.shape == (b, N * 63)
    np.testing.assert_allclose(tobs.numpy(), jobs, atol=PID_ATOL)
    any_done = False
    for t, (jo, jr, jte, jtr) in enumerate(ref):
        tc, to, tr, tte, ttr = t_step(tc, torch.from_numpy(acts[t]))
        assert to.dtype == torch.float32
        np.testing.assert_array_equal(tte.numpy(), jte, f"t={t}")
        np.testing.assert_array_equal(ttr.numpy(), jtr, f"t={t}")
        np.testing.assert_allclose(tr.numpy(), jr, rtol=RTOL, atol=PID_ATOL,
                                   err_msg=f"reward t={t}")
        np.testing.assert_allclose(to.numpy(), jo, rtol=RTOL, atol=PID_ATOL,
                                   err_msg=f"obs t={t}")
        any_done |= bool(np.any(jte | jtr))
    return any_done


@pytest.mark.parametrize("entry", ["make_batched_step", "make_fused_rollout"])
def test_routing_rollout_matches_jax(entry):
    _rollout(getattr(tfast, entry), B, steps=6, scale=0.3, seed=5)


@pytest.mark.parametrize("entry", ["make_batched_step", "make_fused_rollout"])
def test_routing_rollout_unshaped_absolute_matches_jax(entry):
    """The analysis form of the task: -distance reward and absolute
    destinations as actions (the reference's PID convention)."""
    _rollout(getattr(tfast, entry), B, steps=4, scale=0.5, seed=6,
             shaped=False, relative_actions=False, step_size=0.5)


@pytest.mark.parametrize("entry", ["make_batched_step", "make_fused_rollout"])
def test_routing_rollout_resets_an_env(entry):
    """A 0.11 s episode (no tie: 24/240 < 0.11 < 32/240) ends on control
    step 5 for every env: the reset and the first steps of the next episode
    agree as well, the PID carry zeroed."""
    assert _rollout(getattr(tfast, entry), B, steps=8, scale=0.3, seed=7,
                    episode_len_sec=0.11)


@pytest.mark.parametrize("entry", ["make_batched_step", "make_fused_rollout"])
def test_routing_rollout_tilts_and_resets(entry):
    """Random waypoints at 30 Hz kick the attitude loop: within about seven
    control steps a drone tilts past 0.8 rad and its env truncates, in both
    packages on the same step."""
    assert _rollout(getattr(tfast, entry), B, steps=10, scale=0.3, seed=8)


def test_routing_pyb_default_matches_jax():
    """`make_routing_config()` with no arguments — four drones, PYB
    physics — runs through both entry points and gives the JAX package's
    XLA result."""
    from gym_pybullet_drones_tpu.envs import (
        make_routing_config as j_routing_config)
    from gym_pybullet_drones_tpu_torch.envs import make_routing_config
    cfg, task = make_routing_config()
    assert cfg.physics == TE.Physics.PYB and cfg.num_drones == 4
    jcfg, jtask = j_routing_config()
    b = 2
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    acts = (0.3 * np.random.default_rng(9).normal(size=(2, b, 4, 3))) \
        .astype(np.float32)
    for make in (tfast.make_fused_rollout, tfast.make_batched_step):
        js, jobs = j_reset()
        reset, step = make(cfg, task, b, obs_layout="flat", device="cpu")
        tc, tobs = reset()
        assert tobs.shape == (b, 4 * 63)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs),
                                   atol=PID_ATOL)
        for a in acts:
            js, jo, jr, jte, jtr = j_step(js, jnp.asarray(a))
            tc, to, tr, tte, ttr = step(tc, torch.from_numpy(a))
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                       atol=PID_ATOL)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                                       atol=PID_ATOL)
            assert tte.tolist() == np.asarray(jte).tolist()
            assert ttr.tolist() == np.asarray(jtr).tolist()
