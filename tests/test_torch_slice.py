"""The port as a whole against the JAX package: both of the port's
rollout entry points over a full zero-action Hover episode (truncation on
control step 242, the reset after it), and both packages continued from one
mid-rollout state carried across through convert.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gym_pybullet_drones_tpu.envs import fast as jfast
from gym_pybullet_drones_tpu.ops import pallas_fused
from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import fast as tfast
from gym_pybullet_drones_tpu_torch.ops import kernel_fused

from tests._torch_helpers import ATOL, RTOL, pair

LEAVES = ("pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm",
          "action_buffer", "step_counter")


def _j_batched(kind, b):
    (jcfg, jtask), _ = pair(kind)
    reset, step = jfast.make_batched_step(jcfg, jtask, b, use_pallas=False,
                                          obs_layout="flat")
    return reset, jax.jit(step)


def _close(got, ref, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def test_zero_action_episode_matches_jax():
    b, steps = 4, 300
    (jcfg, _), (tcfg, ttask) = pair("hover")
    j_reset, j_step = _j_batched("hover", b)
    f_reset, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    b_reset, b_step = tfast.make_batched_step(tcfg, ttask, b,
                                              obs_layout="flat", device="cpu")
    js, jobs = j_reset()
    fc, fobs = f_reset()
    bs, bobs = b_reset()
    _close(fobs, jobs)
    _close(bobs, jobs)
    ja = jnp.zeros((b, 1, 4), jnp.float32)
    ta = torch.zeros((b, 1, 4))
    trunc_steps = []
    for t in range(1, steps + 1):
        js, jo, jr, jte, jtr = j_step(js, ja)
        fc, fo, fr, fte, ftr = f_step(fc, ta)
        bs, bo, br, bte, btr = b_step(bs, ta)
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _close(r, jr, f"reward t={t}")
            _close(o, jo, f"obs t={t}")
        if bool(ftr.any()):
            assert bool(ftr.all())
            trunc_steps.append(t)
            # the reset after it: obs is the initial obs, counters are zero
            _close(fo, jobs)
            assert torch.equal(bs.step_counter,
                               torch.zeros(b, dtype=torch.int32))
            assert torch.all(fc[-1] == 0)
        # a symmetric hover stays bitwise symmetric on both of the
        # port's paths: x = y = 0 and the identity quaternion
        assert torch.all(fo[:, 0:2] == 0) and torch.all(bo[:, 0:2] == 0)
        assert torch.equal(fc[3:7], torch.tensor([[0.], [0.], [0.], [1.]])
                           .expand(4, b))
        assert torch.all(fr == fr[0])
    assert trunc_steps == [242]
    assert int(bs.step_counter[0]) == (steps - 242) * 8
    assert np.array_equal(np.asarray(js.step_counter),
                          bs.step_counter.numpy())


@pytest.mark.parametrize("kind", ["hover", "multihover"])
def test_continue_from_a_carried_jax_state(kind):
    """JAX runs 6 steps; its state goes through convert.py into both of the
    port's carries; all three continue on the same actions and agree.  Then
    the port's state goes back and the JAX package continues from it."""
    b = 4
    (jcfg, jtask), (tcfg, ttask) = pair(kind)
    n = jcfg.num_drones
    rng = np.random.default_rng(9)
    acts = (0.6 * rng.normal(size=(12, b, n, 4))).astype(np.float32)
    j_reset, j_step = _j_batched(kind, b)
    js, _ = j_reset()
    for t in range(6):
        js = j_step(js, jnp.asarray(acts[t], jnp.float32))[0]
    leaves = {k: np.asarray(getattr(js, k)) for k in LEAVES}
    assert leaves["pos"].dtype == np.float32

    _, b_step = tfast.make_batched_step(tcfg, ttask, b, obs_layout="flat",
                                        device="cpu")
    _, f_step = tfast.make_fused_rollout(tcfg, ttask, b, device="cpu")
    bs = convert.env_state_from_numpy(leaves, device="cpu")
    assert bs.step_counter.dtype == torch.int32
    jcarry = np.asarray(pallas_fused.pack_carry(leaves, n, 60, b, jtask.act))
    assert jcarry.shape[1] == 128                     # lane padding
    fc = convert.fused_carry_from_numpy(jcarry, b, device="cpu")
    assert fc.shape == (n * 80 + 1, b)
    np.testing.assert_array_equal(convert.fused_carry_to_numpy(fc), jcarry)

    for t in range(6, 12):
        js, jo, jr, jte, jtr = j_step(js, jnp.asarray(acts[t], jnp.float32))
        bs, bo, br, bte, btr = b_step(bs, torch.from_numpy(acts[t]))
        fc, fo, fr, fte, ftr = f_step(fc, torch.from_numpy(acts[t]))
        for o, r, te, tr in ((fo, fr, fte, ftr), (bo, br, bte, btr)):
            np.testing.assert_array_equal(te.numpy(), np.asarray(jte))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            _close(r, jr, f"reward t={t}")
            _close(o, jo, f"obs t={t}")
    for k in LEAVES:
        _close(getattr(bs, k), getattr(js, k), k)

    # and back: the JAX package continues from the port's state
    back = convert.env_state_to_numpy(bs)
    js2 = js._replace(**{k: jnp.asarray(back[k]) for k in LEAVES})
    a = jnp.zeros((b, n, 4), jnp.float32)
    out1, out2 = j_step(js, a), j_step(js2, a)
    np.testing.assert_allclose(np.asarray(out2[1]), np.asarray(out1[1]),
                               rtol=RTOL, atol=ATOL)


def test_entry_points_refuse_to_run_without_a_card():
    """device=None means the CUDA card: where there is none the entry
    points raise, they do not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, (tcfg, ttask) = pair("hover")
    for make in (tfast.make_fused_rollout, tfast.make_batched_step):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(tcfg, ttask, 4)
    # the helpers that build tensors follow the same rule
    leaves = {"pos": np.zeros((2, 3), np.float32),
              "quat": np.zeros((2, 4), np.float32),
              "vel": np.zeros((2, 3), np.float32),
              "rpy_rates": np.zeros((2, 3), np.float32),
              "ang_v": np.zeros((2, 3), np.float32),
              "last_rpm": np.zeros((2, 4), np.float32),
              "action_buffer": np.zeros((2, 60), np.float32),
              "step_counter": np.zeros((2,), np.float32)}
    for call in (tcfg.default_init_xyzs, tcfg.default_init_rpys,
                 lambda: kernel_fused.pack_carry(leaves, 1, 60, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert kernel_fused.pack_carry(leaves, 1, 60, 2, device="cpu").shape \
        == (81, 2)
