"""The plain PyTorch version of the `fused_env_step` kernel, through the
port's `make_fused_rollout`, against the JAX package: once against the
Pallas kernel in interpret mode, and against the XLA batched path
(`make_batched_step(use_pallas=False)`) where interpret mode is too slow.
On the CPU the wrapper runs the plain version; the CUDA kernel is held
against the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import fast as jfast
from gym_pybullet_drones_tpu_torch.envs import fast as tfast
from gym_pybullet_drones_tpu_torch.ops import kernel_fused
from gym_pybullet_drones_tpu_torch.utils import enums as TE

from tests._torch_helpers import ATOL, PID_ATOL, RTOL, pair, routing_pair


def _compare(j_make, kind, act, b, steps, scale, seed=0, atol=ATOL):
    (jcfg, jtask), (tcfg, ttask) = routing_pair(3, 0.4) \
        if kind == "routing" else pair(kind, act)
    n = jcfg.num_drones
    act_dim = jtask.action_buffer_shape(jcfg)[1]
    j_reset, j_step = j_make(jcfg, jtask, b)
    t_reset, t_step = tfast.make_fused_rollout(tcfg, ttask, b,
                                               obs_layout="flat",
                                               device="cpu")
    jc, jobs = j_reset()
    tc, tobs = t_reset()
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=atol)
    j_step = jax.jit(j_step)
    rng = np.random.default_rng(seed)
    any_done = False
    for t in range(steps):
        a = (scale * rng.normal(size=(b, n, act_dim))).astype(np.float32)
        jc, jo, jr, jte, jtr = j_step(jc, jnp.asarray(a, jnp.float32))
        tc, to, tr, tte, ttr = t_step(tc, torch.from_numpy(a))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte), f"t={t}")
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr), f"t={t}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                                   atol=atol, err_msg=f"t={t}")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                   atol=atol, err_msg=f"t={t}")
        any_done |= bool(np.any(np.asarray(jte | jtr)))
    return any_done


def _j_fused(cfg, task, b):
    return jfast.make_fused_rollout(cfg, task, b, obs_layout="flat",
                                    use_pallas=True)


def _j_batched(cfg, task, b):
    return jfast.make_batched_step(cfg, task, b, use_pallas=False,
                                   obs_layout="flat")


def test_fused_hover_matches_pallas_interpret():
    """b = 8 pads to one 128-lane kernel block.  The time is the
    interpreted kernel's compile, not the batch or the steps;
    tests/test_fused.py compiles the same program (same config, B = 8),
    so the persistent compilation cache shares it."""
    _compare(_j_fused, "hover", "rpm", b=8, steps=6, scale=0.3)


def test_fused_hover_autoreset_matches_xla():
    """Large random actions tumble drones -> truncations -> resets."""
    assert _compare(_j_batched, "hover", "rpm", b=8, steps=10, scale=1.0)


def test_fused_one_d_rpm_matches_xla():
    _compare(_j_batched, "hover", "one_d_rpm", b=8, steps=10, scale=0.3)


def test_fused_multihover_matches_xla():
    assert _compare(_j_batched, "multihover", "rpm", b=4, steps=10,
                    scale=0.8)


@pytest.mark.parametrize("act", ["one_d_pid", "vel", "pid"])
def test_fused_pid_family_matches_xla(act):
    """The embedded DSL-PID ticks inside the step (9 carry rows per drone);
    tolerance of tests/test_fused.py:83-95, 5e-5 absolute."""
    _compare(_j_batched, "hover", act, b=8, steps=6, scale=0.3,
             atol=PID_ATOL)


def test_fused_one_d_pid_matches_pallas_interpret():
    """One kernel block; the compile shared with tests/test_fused.py's
    ONE_D_PID case at B = 8, as above."""
    _compare(_j_fused, "hover", "one_d_pid", b=8, steps=3, scale=0.3,
             atol=PID_ATOL)


def test_fused_routing_matches_xla():
    """Three drones 0.4 m apart, PID waypoint actions, 6 extra obs rows per
    drone (tests/test_fused.py:98-102, on DYN physics here)."""
    _compare(_j_batched, "routing", None, b=4, steps=6, scale=0.3,
             atol=PID_ATOL)


def test_layout_rows():
    assert kernel_fused._layout(1, 60) == (80, 81)
    assert kernel_fused._layout(1, 15, TE.ActionType.ONE_D_RPM) == (35, 36)
    assert kernel_fused._layout(2, 60) == (80, 161)
    for kind, act, rc, ro in (("hover", "rpm", 81, 75),
                              ("hover", "one_d_rpm", 36, 30),
                              ("multihover", "rpm", 161, 147)):
        _, (tcfg, ttask) = pair(kind, act)
        spec = kernel_fused.FusedSpec(
            tcfg, ttask, ((0.0,) * 16,) * tcfg.num_drones)
        assert (spec.carry_rows, spec.out_rows) == (rc, ro)
    # the PID family carries 9 more rows per drone, before the ring
    assert kernel_fused._layout(1, 45, TE.ActionType.PID) == (74, 75)
    assert kernel_fused._layout(4, 45, TE.ActionType.PID) == (74, 297)
    for act, rc, ro in (("one_d_pid", 45, 30), ("vel", 90, 75),
                        ("pid", 75, 60)):
        _, (tcfg, ttask) = pair("hover", act)
        spec = kernel_fused.FusedSpec(tcfg, ttask, ((0.0,) * 16,))
        assert (spec.carry_rows, spec.out_rows, spec.n_extra) == (rc, ro, 0)
    _, (rcfg, rtask) = routing_pair(4)
    spec = kernel_fused.FusedSpec(rcfg, rtask, ((0.0,) * 16,) * 4)
    assert (spec.carry_rows, spec.out_rows, spec.n_extra) == (297, 255, 6)
    with pytest.raises(ValueError):
        kernel_fused._layout(1, 45, "pid")


@pytest.mark.parametrize("layout", ["flat", "drone", "rows"])
def test_obs_layouts_agree(layout):
    _, (tcfg, ttask) = pair("multihover", "rpm")
    b = 3
    outs = {}
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(b, 2, 4)).astype(np.float32))
    for lay in ("flat", layout):
        reset, step = tfast.make_fused_rollout(tcfg, ttask, b,
                                               obs_layout=lay, device="cpu")
        c, obs0 = reset()
        outs[lay] = (obs0, step(c, a)[1])
    for ref, got in zip(outs["flat"], outs[layout]):
        if layout == "drone":
            assert got.shape == (b, 2, 72)
            got = got.reshape(b, 144)
        elif layout == "rows":
            assert got.shape == (144, b)
            got = got.t()
        assert torch.equal(ref, got)


@pytest.mark.parametrize("why", ["noise", "pid", "no_row_post", "layout"])
def test_fused_rejects_ineligible(why):
    from gym_pybullet_drones_tpu_torch.envs import (
        HoverTask, RLTask, VelocityTask)
    _, (tcfg, _) = pair()
    kw = {}
    if why == "noise":
        task = HoverTask(reset_pos_noise=0.1)
    elif why == "pid":
        # HoverTask's PID-family actions are taken; an embedded-PID task
        # without KIN observations and row hooks is not
        tfast.make_fused_rollout(tcfg, HoverTask(act=TE.ActionType.PID), 4,
                                 device="cpu")
        task = VelocityTask()
    elif why == "no_row_post":
        task = RLTask()
    else:
        task, kw = HoverTask(), {"obs_layout": "tiles"}
    with pytest.raises(ValueError):
        tfast.make_fused_rollout(tcfg, task, 4, device="cpu", **kw)


def test_pyb_hover_through_both_entry_points():
    """The PYB family goes through both entry points: a Hover step under
    PYB (the spawn 0.1 m over the ground) gives the JAX package's XLA
    result, at tests/test_fused.py's tolerance."""
    import dataclasses
    from gym_pybullet_drones_tpu.utils import enums as JE
    (jcfg, jtask), (tcfg, ttask) = pair()
    jpyb = dataclasses.replace(jcfg, physics=JE.Physics.PYB)
    pyb = dataclasses.replace(tcfg, physics=TE.Physics.PYB)
    b = 4
    j_reset, j_step = _j_batched(jpyb, jtask, b)
    j_step = jax.jit(j_step)
    a = (0.3 * np.random.default_rng(9).normal(size=(2, b, 1, 4))) \
        .astype(np.float32)
    for make in (tfast.make_fused_rollout, tfast.make_batched_step):
        js, jobs = j_reset()
        reset, step = make(pyb, ttask, b, obs_layout="flat", device="cpu")
        tc, tobs = reset()
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=ATOL)
        for t in range(2):
            js, jo, jr, jte, jtr = j_step(js, jnp.asarray(a[t]))
            tc, to, tr, tte, ttr = step(tc, torch.from_numpy(a[t]))
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL,
                                       atol=ATOL)
            assert tte.tolist() == np.asarray(jte).tolist()
            assert ttr.tolist() == np.asarray(jtr).tolist()
    # what the fused spec still refuses is a capacity
    with pytest.raises(ValueError, match="obstacles"):
        tfast.make_fused_rollout(dataclasses.replace(
            pyb, obstacles=((0.0, 0.0, 5.0, 0.1),) * 9), ttask, b,
            device="cpu")


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    _, (tcfg, ttask) = pair()
    reset, _ = tfast.make_fused_rollout(tcfg, ttask, 4, device="cpu")
    carry, _ = reset()
    spec = kernel_fused.FusedSpec(tcfg, ttask, ((0.0,) * 16,))
    good = torch.zeros((4, 4))
    for c, a in ((carry.double(), good), (carry[:80].contiguous(), good),
                 (carry, torch.zeros((4, 5))), (carry, torch.zeros((3, 4))),
                 (carry, torch.zeros((4, 4)).t()[:, :4].t().t())):
        with pytest.raises((TypeError, ValueError)):
            kernel_fused.fused_env_step(spec, c, a)
