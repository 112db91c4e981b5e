"""The port's data-parallel layer (gym_pybullet_drones_tpu_torch/parallel/,
`make_train(..., mesh=)`, the sharded population and checkpoints), on the
CPU over gloo.

One module-scoped fixture spawns 2 ranks once (`parallel.launch.
run_ranks`, a `file://` rendezvous under the test's tmp_path, so that no
port is shared between xdist workers); the ranks run every case of
`tests/_torch_dist_worker.py` while this process compiles the JAX
package's sharded updates, and a timeout fails the fixture.  The cases:

(a) one sharded update at R = 2 against the JAX package's
    `make_sharded_update` on 2 of conftest's virtual devices, from the
    same weights on the same draws (the JAX key schedule replayed as
    `tests/test_torch_ppo.py` replays it), Hover on DYN (the port's fused
    path) and on PYB (its batched path); held to test_torch_ppo.py's
    tolerances;
(b) the sharded update against the port's own single-process update,
    on the fused path and on the batched path of a task with reset noise
    (each rank keeps its rows of the global draws);
(c) a population of K = 2 over 2 ranks against the unsharded one, with
    no collective;
(d) a checkpoint saved at R = 2, resumed at R = 2 and at R = 1, saved at
    R = 1 and resumed at R = 2;
(e) `sb3_minibatching` under a mesh (the rollout gathered once);
(f) the refusals, which need no group;
and `utils/profiling.py`.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_pybullet_drones_tpu import params as JP
from gym_pybullet_drones_tpu.envs import AviaryConfig as JConfig
from gym_pybullet_drones_tpu.envs import HoverTask as JHover
from gym_pybullet_drones_tpu.parallel import (
    make_mesh as j_make_mesh, make_sharded_update as j_sharded_update,
    shard_train_state as j_shard)
from gym_pybullet_drones_tpu.rl import ppo as jppo
from gym_pybullet_drones_tpu.utils import enums as JE

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.parallel import (
    Mesh, initialize, make_mesh, make_sharded_update)
from gym_pybullet_drones_tpu_torch.parallel.launch import run_ranks
from gym_pybullet_drones_tpu_torch.rl import make_train, population

from tests import _torch_dist_worker as W
from tests._torch_helpers import ATOL, RTOL
from tests.test_torch_ppo import METRIC_TOL, OBS_ATOL, PARAM_ATOL

R = 2
# the spawn, the rendezvous and every case: about 15 s on 2 idle cores
RANKS_TIMEOUT_S = 300
STATE_FIELDS = ("pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm")
JAX_CASES = {"dyn": ("dyn", "fused"), "pyb": ("pyb", "batched")}


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if getattr(x, "dtype", None) == jnp.float64 else x, tree)


def _jax_draws(key):
    """What one JAX update draws from `key`, in its own order
    (tests/test_torch_ppo.py's replay): (noise (T, E, 4), perms)."""
    noise, perms = [], []
    for _ in range(W.T):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (W.E, 4),
                                                  jnp.float32)))
    for _ in range(W.EPOCHS):
        key, sub = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(sub, W.T)))
    return np.stack(noise), np.stack(perms).astype(np.int64)


def _numpy_state_dict(params):
    return {k: v.numpy() for k, v in convert.actor_critic_state_dict_from_flax(
        jax.tree.map(np.asarray, params)).items()}


def _jax_side(physics, ts0=None):
    """The JAX package's trainer on a 2-device mesh: its float32 initial
    state (or `ts0`, another physics' (the same reset and weights)), and
    the jitted sharded update (not yet run)."""
    jcfg = JConfig(drone=JP.CF2X, num_drones=1,
                   physics=JE.Physics(W.PHYSICS[physics].value),
                   pyb_freq=240, ctrl_freq=30)
    jtask = dataclasses.replace(JHover(act=JE.ActionType.RPM),
                                episode_len_sec=W.EPISODE_S)
    jp = jppo.PPOConfig(num_envs=W.E, rollout_steps=W.T,
                        num_minibatches=W.MB, update_epochs=W.EPOCHS)
    mesh = j_make_mesh(jax.devices()[:R])
    init, update, _, _ = jppo.make_train(jcfg, jtask, jp, mesh=mesh,
                                         env_path="batched")
    if ts0 is None:
        ts0 = _f32(jax.jit(init)(jax.random.key(0)))
    return ts0, lambda: j_sharded_update(update, mesh)(j_shard(ts0, mesh))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(what each rank returned, {case: (JAX TrainState, metrics)})."""
    sides = {"dyn": _jax_side("dyn")}
    sides["pyb"] = _jax_side("pyb", sides["dyn"][0])
    inputs = {name: (physics, path, _numpy_state_dict(sides[name][0].params),
                     *_jax_draws(sides[name][0].key))
              for name, (physics, path) in JAX_CASES.items()}
    directory = str(tmp_path_factory.mktemp("ranks"))
    # the ranks' work and the two JAX compiles overlap
    with concurrent.futures.ThreadPoolExecutor(1 + len(sides)) as pool:
        spawned = pool.submit(
            run_ranks, W.run_cases, R, "gloo",
            args=(inputs, directory), device="cpu",
            timeout_s=RANKS_TIMEOUT_S, rendezvous_dir=directory)
        runs = {name: pool.submit(run) for name, (_, run) in sides.items()}
        expected = {name: run.result() for name, run in runs.items()}
        results = spawned.result()
    assert [r["rank"] for r in results] == list(range(R))
    return results, expected


def _adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _moments_close(got, want, what):
    # test_torch_population.py's tolerance for the Adam moments: 1e-4 of
    # each tensor's largest entry
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, rtol=0,
                                   atol=1e-4 * float(np.abs(v).max()),
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_sharded_update_matches_jax_sharded_update(ranks, name):
    results, expected = ranks
    jts, jm = expected[name]
    adam = _adam(jts.opt_state)
    want_params = _numpy_state_dict(jts.params)
    for res in results:
        got = res["jax"][name]
        lo, hi = got["cols"]
        assert (lo, hi) == (res["rank"] * W.E // R,
                            (res["rank"] + 1) * W.E // R)
        assert got["update_idx"] == 1 and got["count"] == W.EPOCHS * W.MB
        assert got["last_obs"].dtype == np.float32
        np.testing.assert_allclose(got["last_obs"],
                                   np.asarray(jts.last_obs)[lo:hi],
                                   rtol=0, atol=OBS_ATOL)
        for field in STATE_FIELDS:
            want = np.asarray(getattr(jts.env_state, field))
            want = want.reshape(W.E, -1)[lo:hi]
            assert got["env"][field].dtype == np.float32, field
            # last_rpm is of order 1.4e4, where a float32 ulp is 1e-3:
            # tests/_torch_helpers.py's state tolerance (test_fused.py's)
            tol = dict(rtol=RTOL, atol=ATOL) if field == "last_rpm" \
                else dict(rtol=0, atol=OBS_ATOL)
            np.testing.assert_allclose(
                got["env"][field].reshape(hi - lo, -1), want,
                err_msg=field, **tol)
        for k, v in jm.items():
            np.testing.assert_allclose(got["metrics"][k], float(v),
                                       err_msg=k, **METRIC_TOL)
        for k, v in want_params.items():
            assert got["params"][k].dtype == np.float32, k
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
        _moments_close(got["mu"], _numpy_state_dict(adam.mu), "mu")
        _moments_close(got["nu"], _numpy_state_dict(adam.nu), "nu")


def _hold(got, want, exact_obs=False):
    """A gathered sharded record against a single-process one."""
    assert got["update_idx"] == want["update_idx"] == 1
    np.testing.assert_allclose(got["last_obs"], want["last_obs"], rtol=0,
                               atol=0 if exact_obs else OBS_ATOL)
    for field in STATE_FIELDS:
        np.testing.assert_allclose(got["env"][field], want["env"][field],
                                   rtol=0, atol=OBS_ATOL, err_msg=field)
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, err_msg=k,
                                   **METRIC_TOL)
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    _moments_close(got["mu"], want["mu"], "mu")
    _moments_close(got["nu"], want["nu"], "nu")


@pytest.mark.parametrize("name", ["fused", "batched_noise", "sb3"])
def test_sharded_update_matches_one_process(ranks, name):
    results, _ = ranks
    want = results[0]["single"][name]["single"]
    for res in results:
        case = res["single"][name]
        # the rollout steps each env alone: the sharded one's obs and
        # state are the single one's bit for bit
        _hold(case["sharded"], want, exact_obs=True)
        for field in STATE_FIELDS:
            np.testing.assert_array_equal(case["sharded"]["env"][field],
                                          want["env"][field])
    collectives = results[0]["single"][name]["collectives"]
    if name == "sb3":
        # the rollout gathered once (its 6 leaves, the advantages and the
        # returns), then the same full-batch steps on every rank
        assert collectives == 8
    else:
        # 3 a step (2 advantage statistics, 1 gradient), the metrics once
        assert collectives == 3 * W.EPOCHS * W.MB + 1
    for res in results:
        # a rank's init is its shard of one process's, noise block too
        own, cut = res["single"][name]["init"]
        _same(own, cut)
        if own["noise"] is not None or cut["noise"] is not None:
            np.testing.assert_array_equal(own["noise"], cut["noise"])
    if name == "batched_noise":
        # the draws of the reset and of 8 control steps
        assert results[0]["single"][name]["noise_index"] == 1 + W.T


@pytest.mark.parametrize("name", ["fused", "batched_noise", "sb3"])
def test_sharded_update_records_its_collectives(ranks, name):
    """Each rank's `Mesh.collective_bytes` and `mesh.*` spans against the
    collectives torch.distributed was handed during the update."""
    results, _ = ranks
    for res in results:
        got = res["single"][name]["collective_record"]
        calls, nbytes = got["dist_calls"]
        assert got["collectives"] == calls > 0
        assert got["collective_bytes"] == nbytes > 0
        spans = got["spans"]
        assert sum(s["count"] for s in spans.values()) == calls
        assert sum(s["attrs"]["bytes"] for s in spans.values()) == nbytes
        assert spans["mesh.all_reduce"]["count"] == calls


def test_sharded_population_needs_no_collective(ranks):
    results, _ = ranks
    want = results[0]["population"]["single"]
    for res in results:
        pop = res["population"]
        assert pop["mesh_collectives"] == 0 and pop["dist_calls"] == 0
        lo, hi = pop["members"]
        assert hi - lo == W.K // R
        got = pop["local"]
        np.testing.assert_array_equal(
            got["last_obs"], want["last_obs"][lo:hi])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v[lo:hi],
                                       err_msg=k, **METRIC_TOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v[lo:hi], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
        _moments_close(got["mu"], {k: v[lo:hi] for k, v in
                                   want["mu"].items()}, "mu")


def _same(a, b):
    """Two records, bit for bit."""
    for key in ("params", "mu", "nu", "env", "metrics"):
        assert a[key].keys() == b[key].keys(), key
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k],
                                          err_msg=f"{key} {k}")
    np.testing.assert_array_equal(a["last_obs"], b["last_obs"])
    assert (a["update_idx"], a["count"]) == (b["update_idx"], b["count"])


def _same_payload(a, b):
    """Two checkpoint payloads (numpy), entry by entry, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_payload(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_payload(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", ["batched_noise", "fused"])
def test_checkpoint_across_mesh_sizes(ranks, name):
    results, _ = ranks
    zero = results[0]["checkpoint"][name]
    # R = 1 restores exactly the gathered R = 2 state, and writes the
    # same file for it
    _same(zero["r1_state"], zero["gathered"])
    _same_payload(*zero["files"])
    for res in results:
        ck = res["checkpoint"][name]
        _same(ck["r2"], ck["a2"])          # resumed at R = 2
        _same(ck["r1_to_r2"], ck["a2"])    # saved at R = 1, back at R = 2
    # R = 1's continuation is the same update on the global batch
    lo, hi = results[1]["checkpoint"][name]["cols"]
    a2 = results[1]["checkpoint"][name]["a2"]
    np.testing.assert_array_equal(a2["last_obs"], zero["b1"]["last_obs"][lo:hi])
    for k, v in zero["b1"]["params"].items():
        np.testing.assert_allclose(a2["params"][k], v, rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _hover():
    return W.config()


def test_refusals_without_a_group(monkeypatch):
    cfg, task = _hover()
    two = Mesh(0, 2, "cpu", "gloo")
    # an env batch, a population that the ranks cannot split evenly
    with pytest.raises(ValueError, match="divide evenly"):
        make_train(cfg, task, dataclasses.replace(W.ppo(), num_envs=5),
                   mesh=two)
    pinit, pupdate, _, _ = population.make_train_population(
        cfg, task, W.ppo(), 3, device="cpu")
    with pytest.raises(ValueError, match="num_policies=3 must divide"):
        population.make_sharded_population_update(pupdate, two)
    with pytest.raises(ValueError, match="num_policies=3 must divide"):
        population.shard_population(
            pinit(torch.Generator().manual_seed(0)), two)
    # an update built for another mesh, or for none
    update = make_train(cfg, task, W.ppo(), device="cpu")[1]
    with pytest.raises(ValueError, match="not built for this mesh"):
        make_sharded_update(update, two)
    # NCCL takes one card a rank, and --sharded refuses before it spawns
    with pytest.raises(RuntimeError, match="--backend gloo"):
        initialize("127.0.0.2:1", 2, 0, "nccl")
    from gym_pybullet_drones_tpu_torch.examples import train_to_threshold
    with pytest.raises(RuntimeError, match="--backend gloo"):
        train_to_threshold.main(["--sharded", "2", "--device", "cpu"])
    # a group of two that cannot form raises; none is formed quietly
    with pytest.raises(RuntimeError, match="rendezvous"):
        initialize("unknown://nowhere", 2, 0, "gloo")
    with pytest.raises(ValueError, match="process_id 2"):
        initialize("127.0.0.2:1", 2, 2, "gloo")
    with pytest.raises(ValueError, match="backend"):
        initialize(None, 1, 0, "mpi")
    assert initialize(None, 1, 0, "gloo") == 0
    # device=None means the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_profiling_trace_and_rate(tmp_path):
    """`measure_steps_per_sec` steps and reads back; `trace` writes a
    Chrome trace of the block."""
    from gym_pybullet_drones_tpu_torch.envs import make_fused_rollout
    from gym_pybullet_drones_tpu_torch.utils import profiling
    cfg, task = _hover()
    reset, step = make_fused_rollout(cfg, task, 4, device="cpu")
    act = torch.zeros((4, 1, 4))
    one = lambda carry: step(carry, act)[0]
    with profiling.trace(str(tmp_path / "trace")) as prof:
        rate, carry = profiling.measure_steps_per_sec(one, reset()[0],
                                                      n_iters=2)
    assert rate > 0 and carry.shape[1] == 4
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
    with pytest.raises(ValueError, match="no floating tensor"):
        profiling.measure_steps_per_sec(lambda s: s, torch.zeros(
            2, dtype=torch.int32))
