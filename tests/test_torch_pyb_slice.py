"""The PYB-family slice as a whole: the port's two rollout entry points
(on the CPU: the kernels' plain versions) against the JAX package's XLA
batched path on the same seeded actions.

- the routing fork's DEFAULT configuration (PYB physics, embedded DSL-PID,
  ground and drone-drone contact), 3 drones 0.4 m apart, 6 steps: 5e-5
  absolute / 1e-4 relative on observations and reward, flags equal
  (tests/test_fused.py:98-102);
- MultiHover under PYB_GND_DRAG_DW with a STACKED spawn (at one height the
  downwash sits on its dz > 0 tie), 4 steps: 2e-5 / 1e-4
  (tests/test_fused.py:73-80);
- Hover under PYB_GND_DRAG_DW over an episode's end: truncation, auto-reset
  (last_rpm zeroed: no drag in the next substep 0) and the steps after it;
- a carry and an EnvState handed across with convert.py mid-rollout, both
  ways."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu import params as JP
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig as JConfig, HoverTask as JHover,
    MultiHoverTask as JMultiHover, fast as jfast,
    make_routing_config as j_routing_config)
from gym_pybullet_drones_tpu.ops import pallas_fused
from gym_pybullet_drones_tpu.utils import enums as JE

from gym_pybullet_drones_tpu_torch import convert, params as TP
from gym_pybullet_drones_tpu_torch.envs import (
    AviaryConfig as TConfig, HoverTask as THover,
    MultiHoverTask as TMultiHover, fast as tfast,
    make_routing_config as t_routing_config)
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import ATOL, PID_ATOL, RTOL

ENTRIES = ("make_batched_step", "make_fused_rollout")
STACKED = ((0.0, 0.0, 0.08), (0.05, 0.0, 0.6))


def _pair(kind):
    """((jax cfg, jax task), (port cfg, port task), atol)."""
    if kind == "routing":
        return j_routing_config(3, 0.4), t_routing_config(3, 0.4), PID_ATOL
    if kind == "multihover_aero":
        kw = dict(num_drones=2, pyb_freq=240, ctrl_freq=60,
                  init_xyzs=STACKED)
        return ((JConfig(drone=JP.CF2X, physics=JE.Physics.PYB_GND_DRAG_DW,
                         **kw), JMultiHover()),
                (TConfig(drone=TP.CF2X, physics=TE.Physics.PYB_GND_DRAG_DW,
                         **kw), TMultiHover()), ATOL)
    # hover_aero: the spawn 0.1 m over the ground, an episode of 0.11 s
    # (no tie: 24/240 < 0.11 < 32/240) that ends on control step 5
    kw = dict(num_drones=1, pyb_freq=240, ctrl_freq=30)
    return ((JConfig(drone=JP.CF2X, physics=JE.Physics.PYB_GND_DRAG_DW, **kw),
             JHover(episode_len_sec=0.11)),
            (TConfig(drone=TP.CF2X, physics=TE.Physics.PYB_GND_DRAG_DW, **kw),
             THover(episode_len_sec=0.11)), ATOL)


@functools.lru_cache(maxsize=None)
def _jax_rollout(kind, b, steps, scale, seed):
    """(reset obs, actions, per step (obs, reward, term, trunc)) of the JAX
    package's XLA batched path, run once for both of the port's entries."""
    (jcfg, jtask), _, _ = _pair(kind)
    n, adim = jcfg.num_drones, jtask.action_dim(jcfg)
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    js, jobs = j_reset()
    acts = (scale * np.random.default_rng(seed).normal(
        size=(steps, b, n, adim))).astype(np.float32)
    out = []
    for a in acts:
        js, *rest = j_step(js, jnp.asarray(a, jnp.float32))
        out.append(tuple(np.asarray(x) for x in rest))
    assert out[0][0].dtype == np.float32
    return np.asarray(jobs), acts, out


def _rollout(kind, entry, b, steps, scale, seed):
    jobs, acts, ref = _jax_rollout(kind, b, steps, scale, seed)
    _, (tcfg, ttask), atol = _pair(kind)
    t_reset, t_step = getattr(tfast, entry)(tcfg, ttask, b,
                                            obs_layout="flat", device="cpu")
    tc, tobs = t_reset()
    np.testing.assert_allclose(tobs.numpy(), jobs, atol=atol)
    dones = []
    for t, (jo, jr, jte, jtr) in enumerate(ref):
        tc, to, tr, tte, ttr = t_step(tc, torch.from_numpy(acts[t]))
        assert to.dtype == torch.float32
        np.testing.assert_array_equal(tte.numpy(), jte, f"t={t}")
        np.testing.assert_array_equal(ttr.numpy(), jtr, f"t={t}")
        np.testing.assert_allclose(tr.numpy(), jr, rtol=RTOL, atol=atol,
                                   err_msg=f"reward t={t}")
        np.testing.assert_allclose(to.numpy(), jo, rtol=RTOL, atol=atol,
                                   err_msg=f"obs t={t}")
        dones.append(bool(np.all(jte | jtr)))
    return dones, tc


@pytest.mark.parametrize("entry", ENTRIES)
def test_default_routing_matches_jax(entry):
    """`make_routing_config`'s default physics is PYB: the configuration
    the routing fork itself runs."""
    _, (tcfg, ttask), _ = _pair("routing")
    assert tcfg.physics == TE.Physics.PYB and ttask.obs_dim(tcfg) == 63
    _rollout("routing", entry, b=4, steps=6, scale=0.3, seed=21)


@pytest.mark.parametrize("entry", ENTRIES)
def test_aero_multihover_stacked_matches_jax(entry):
    """Ground effect and ground contact on the lower drone, the stale drag
    on both, the upper drone's downwash on the lower one."""
    _rollout("multihover_aero", entry, b=4, steps=4, scale=0.05, seed=22)


@pytest.mark.parametrize("entry", ENTRIES)
def test_hover_aero_episode_truncates_and_resets(entry):
    dones, carry = _rollout("hover_aero", entry, b=3, steps=8, scale=0.3,
                            seed=23)
    assert dones == [False] * 4 + [True] + [False] * 3
    counter = carry[-1] if entry == "make_fused_rollout" \
        else carry.step_counter
    assert counter.tolist() == [24, 24, 24]


def test_batched_and_fused_agree_on_a_sphere_and_a_box():
    """Obstacles through both entry points and `core.step`: a drone flung at
    the sphere, one at the box; all three agree and both are stopped."""
    from gym_pybullet_drones_tpu_torch.envs import core as tcore
    cfg = TConfig(drone=TP.CF2X, num_drones=2, physics=TE.Physics.PYB,
                  pyb_freq=240, ctrl_freq=30,
                  init_xyzs=((0.0, 1.82, 0.5), (1.0, 1.92, 0.5)),
                  obstacles=((0.0, 2.0, 0.5, 0.1),
                             (1.0, 2.5, 0.5, 0.5, 0.5, 0.5)))
    task = TMultiHover()
    b = 2
    f_reset, f_step = tfast.make_fused_rollout(cfg, task, b, device="cpu")
    b_reset, b_step = tfast.make_batched_step(cfg, task, b,
                                              obs_layout="flat", device="cpu")
    fc, _ = f_reset()
    fc[7 + 1] = 1.5                       # drone 0: vy
    fc[80 + 7 + 1] = 1.5                  # drone 1: vy
    bs = convert.env_state_from_fused_carry(fc, 2, task.act)
    cs = tcore.map_leaves(
        lambda x: x.reshape((b, 2) + x.shape[1:]) if x.dim() > 1 else x,
        bs)._replace(action_buffer=bs.action_buffer.reshape(b, 2, 15, 4))
    a = torch.zeros((b, 2, 4))
    for t in range(3):
        fc, fo, fr, fte, ftr = f_step(fc, a)
        bs, bo, br, bte, btr = b_step(bs, a)
        cs, co, cr, cte, ctr, _ = tcore.step(cfg, task, cs, a)
        np.testing.assert_allclose(bo.numpy(), fo.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(co.reshape(b, -1).numpy(), fo.numpy(),
                                   rtol=RTOL, atol=ATOL)
        assert fte.tolist() == bte.tolist() == cte.tolist()
        assert ftr.tolist() == btr.tolist() == ctr.tolist()
    assert float(bs.pos[0, 1]) < 2.0 - 0.1 - 0.06 + 2e-3      # the sphere
    assert float(bs.pos[1, 1]) <= 2.0 - 0.06 + 2e-3           # the box face


def test_pyb_carry_and_state_cross_over_mid_rollout():
    """JAX runs 3 steps of the default routing configuration; its state goes
    through convert.py into both of the port's carries; all three continue
    and agree; the port's state goes back and the JAX package continues
    from it.  The carry's row order is the DYN one: nothing is converted."""
    b, n = 4, 3
    (jcfg, jtask), (tcfg, ttask), atol = _pair("routing")
    acts = (0.3 * np.random.default_rng(24).normal(size=(6, b, n, 3))) \
        .astype(np.float32)
    j_reset, j_step = jfast.make_batched_step(jcfg, jtask, b,
                                              use_pallas=False,
                                              obs_layout="flat")
    j_step = jax.jit(j_step)
    js, _ = j_reset()
    for t in range(3):
        js = j_step(js, jnp.asarray(acts[t], jnp.float32))[0]
    leaf_names = ("pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm",
                  "action_buffer", "step_counter")
    pid_names = ("last_rpy", "integral_pos_e", "integral_rpy_e")
    leaves = {k: np.asarray(getattr(js, k)) for k in leaf_names}
    leaves["ctrl_state"] = {k: np.asarray(getattr(js.ctrl_state, k))
                            for k in pid_names}
    assert leaves["ang_v"].any() and leaves["last_rpm"].any()
    bs = convert.env_state_from_numpy(leaves, device="cpu")
    jleaves = dict({k: leaves[k] for k in leaf_names}, pid=np.concatenate(
        [leaves["ctrl_state"][k] for k in pid_names], axis=-1))
    jcarry = np.asarray(pallas_fused.pack_carry(jleaves, n, 45, b, jtask.act))
    fc = convert.fused_carry_from_numpy(jcarry, b, device="cpu")
    np.testing.assert_array_equal(convert.fused_carry_to_numpy(fc), jcarry)
    opened = convert.env_state_from_fused_carry(fc, n, ttask.act)
    for k in leaf_names:
        assert torch.equal(getattr(opened, k), getattr(bs, k)), k
    _, b_step = tfast.make_batched_step(tcfg, ttask, b, obs_layout="flat",
                                        device="cpu")
    _, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    for t in range(3, 6):
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(acts[t], jnp.float32))
        bs, bo, br, bte, btr = b_step(bs, torch.from_numpy(acts[t]))
        fc, fo, fr, fte, ftr = f_step(fc, torch.from_numpy(acts[t]))
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=RTOL,
                                       atol=atol, err_msg=f"reward t={t}")
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL,
                                       atol=atol, err_msg=f"obs t={t}")
    back = convert.env_state_to_numpy(bs)
    js2 = js._replace(
        ctrl_state=type(js.ctrl_state)(
            **{k: jnp.asarray(back["ctrl_state"][k]) for k in pid_names}),
        **{k: jnp.asarray(back[k]) for k in leaf_names})
    a = jnp.zeros((b, n, 3), jnp.float32)
    out1, out2 = j_step(js, a), j_step(js2, a)
    np.testing.assert_allclose(np.asarray(out2[1]), np.asarray(out1[1]),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("sweeps", [1, 50])
def test_entry_points_take_any_sweep_count(sweeps):
    """`cfg.solver_iterations` reaches the kernels as a run-time value: both
    entry points agree with `core.step` for 1 and for 50 sweeps, and the two
    differ from each other (the drone lands within the rollout)."""
    from gym_pybullet_drones_tpu_torch.envs import core as tcore
    cfg = TConfig(drone=TP.CF2X, num_drones=1, physics=TE.Physics.PYB,
                  pyb_freq=240, ctrl_freq=30, init_xyzs=((0.0, 0.0, 0.03),),
                  init_rpys=((0.3, -0.2, 0.0),), solver_iterations=sweeps)
    task = THover()
    f_reset, f_step = tfast.make_fused_rollout(cfg, task, 2, device="cpu")
    b_reset, b_step = tfast.make_batched_step(cfg, task, 2,
                                              obs_layout="flat", device="cpu")
    fc, _ = f_reset()
    bs, _ = b_reset()
    cs, _, _ = tcore.reset(cfg, task, device="cpu")
    a = torch.full((2, 1, 4), -10.0)
    for t in range(4):
        fc, fo, *_ = f_step(fc, a)
        bs, bo, *_ = b_step(bs, a)
        cs, co, *_ = tcore.step(cfg, task, cs, a[0])
        np.testing.assert_allclose(bo.numpy(), fo.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(co.numpy(), fo[:1].numpy(), rtol=3e-4,
                                   atol=5e-4)
    other = tfast.make_fused_rollout(
        dataclasses.replace(cfg, solver_iterations=4), task, 2, device="cpu")
    oc, _ = other[0]()
    for t in range(4):
        oc, oo, *_ = other[1](oc, a)
    assert float((oo - fo).abs().max()) > 1e-6
