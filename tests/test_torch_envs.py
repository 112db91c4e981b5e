"""Port envs/core.py and the per-env task methods against the JAX
package's: reset, step and step_autoreset of one env, and the same
functions broadcast over a leading batch axis."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import core as jcore
from gym_pybullet_drones_tpu_torch.envs import core as tcore

from tests._torch_helpers import ATOL, RTOL, pair


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("kind,act", [("hover", "rpm"),
                                      ("hover", "one_d_rpm"),
                                      ("multihover", "rpm")])
def test_reset_and_step_match_jax(kind, act):
    (jcfg, jtask), (tcfg, ttask) = pair(kind, act)
    n = jcfg.num_drones
    act_dim = jtask.action_dim(jcfg)
    js, jobs, _ = jcore.reset(jcfg, jtask)
    ts, tobs, _ = tcore.reset(tcfg, ttask, device="cpu")
    assert tobs.shape == (n, ttask.obs_dim(tcfg))
    _close(tobs, jobs)
    _close(tcore.state_vector(ts), jcore.state_vector(js))
    j_step = jax.jit(lambda s, a: jcore.step(jcfg, jtask, s, a))
    rng = np.random.default_rng(2)
    for t in range(5):
        a = (0.5 * rng.normal(size=(n, act_dim))).astype(np.float32)
        js, jo, jr, jte, jtr, _ = j_step(js, jnp.asarray(a, jnp.float32))
        ts, to, tr, tte, ttr, _ = tcore.step(tcfg, ttask, ts,
                                             torch.from_numpy(a))
        _close(to, jo, f"obs t={t}")
        _close(tr, jr, f"reward t={t}")
        assert bool(tte) == bool(jte) and bool(ttr) == bool(jtr)
    assert int(ts.step_counter) == int(js.step_counter) == 40
    _close(ts.action_buffer, js.action_buffer)


def test_step_autoreset_batched_matches_jax_vmap():
    """Leading batch dims written out here, vmap there; one env is started
    past the episode's end so that it truncates and resets."""
    (jcfg, jtask), (tcfg, ttask) = pair("multihover")
    b = 3
    js1, _, _ = jcore.reset(jcfg, jtask)
    js = jax.tree.map(lambda x: jnp.stack([x] * b), js1)
    js = js._replace(step_counter=jnp.asarray([0, 1928, 8], jnp.int32))
    ts1, _, _ = tcore.reset(tcfg, ttask, device="cpu")
    ts = tcore.EnvState(*(torch.stack([x] * b) for x in ts1))
    ts = ts._replace(step_counter=torch.tensor([0, 1928, 8],
                                               dtype=torch.int32))
    a = (0.3 * np.random.default_rng(6).normal(size=(b, 2, 4))) \
        .astype(np.float32)
    jout = jax.vmap(lambda s, x: jcore.step_autoreset(jcfg, jtask, s, x))(
        js, jnp.asarray(a, jnp.float32))
    tout = tcore.step_autoreset(tcfg, ttask, ts, torch.from_numpy(a))
    assert tout[4].tolist() == np.asarray(jout[4]).tolist() \
        == [False, True, False]
    _close(tout[1], jout[1], "obs")
    _close(tout[2], jout[2], "reward")
    assert tout[0].step_counter.tolist() == [8, 0, 16]
    for k in ("pos", "quat", "vel", "last_rpm", "action_buffer"):
        _close(getattr(tout[0], k), getattr(jout[0], k), k)


def test_unported_parts_say_so():
    import dataclasses
    from gym_pybullet_drones_tpu_torch.envs import HoverTask
    from gym_pybullet_drones_tpu_torch.utils import enums as TE
    _, (tcfg, ttask) = pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.reset(dataclasses.replace(tcfg, physics=TE.Physics.PYB_DW),
                    ttask, device="cpu")
    ts, _, _ = tcore.reset(tcfg, ttask, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcore.step(tcfg, HoverTask(act=TE.ActionType.VEL), ts,
                   torch.zeros((1, 4)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HoverTask(obs=TE.ObservationType.RGB).compute_obs(tcfg, ts)
    with pytest.raises(NotImplementedError):
        tcore.reset(tcfg, HoverTask(reset_vel_noise=0.1), device="cpu")
    with pytest.raises(ValueError):
        dataclasses.replace(tcfg, ctrl_freq=50)
