"""The rank body of tests/test_torch_parallel.py: every case of the port's
data-parallel layer (gym_pybullet_drones_tpu_torch/parallel/) that needs a
group, run by each of 2 gloo ranks on the CPU in one spawn
(`parallel.launch.run_ranks`).  It imports the port only (no JAX: the
JAX side runs in the test process); the test holds what it returns.

Every case: Hover, RPM, `episode_len_sec=0.125` (each env truncates on
control step 4 and auto-resets inside the 8-step rollout), 8 envs x 8
steps, 2 minibatches, 2 epochs, on the CPU's plain kernel versions.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.convert import (
    env_state_from_fused_carry, env_state_to_numpy)
from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu_torch.parallel import (
    gather_train_state, make_sharded_update, shard_train_state)
from gym_pybullet_drones_tpu_torch.rl import (
    Draws, PPOConfig, make_train, make_train_population)
from gym_pybullet_drones_tpu_torch.rl.population import (
    make_sharded_population_update, shard_population)
from gym_pybullet_drones_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
from gym_pybullet_drones_tpu_torch.utils import profiling
from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics

E, T, MB, EPOCHS, K = 8, 8, 2, 2, 2
EPISODE_S = 0.125
PHYSICS = {"dyn": Physics.DYN, "pyb": Physics.PYB}
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce", "reduce_scatter", "gather", "scatter", "barrier",
               "send", "recv", "isend", "irecv", "all_to_all")


def config(physics="dyn", **task_kw):
    cfg = AviaryConfig(P.CF2X, 1, PHYSICS[physics], 240, 30)
    task = HoverTask(act=ActionType.RPM)
    return cfg, dataclasses.replace(task, episode_len_sec=EPISODE_S,
                                    **task_kw)


def ppo(**kw):
    return PPOConfig(**{**dict(num_envs=E, rollout_steps=T,
                               num_minibatches=MB, update_epochs=EPOCHS),
                        **kw})


def draws(seed, shape=(T, E, 4), n_perm=T, lead=()):
    """Seeded global draws, the same on every rank."""
    rng = np.random.default_rng(seed)
    noise = rng.normal(size=lead + shape).astype(np.float32)
    perms = np.stack([rng.permutation(n_perm)
                      for _ in range(int(np.prod(lead + (EPOCHS,))))])
    return Draws(torch.from_numpy(noise),
                 torch.from_numpy(perms.reshape(lead + (EPOCHS, n_perm))))


def env_leaves(env_state, num_drones=1):
    """{field: (B*N, k) array} of a flat EnvState or a fused carry."""
    if isinstance(env_state, torch.Tensor):
        env_state = env_state_from_fused_carry(env_state, num_drones,
                                               ActionType.RPM)
    out = env_state_to_numpy(env_state)
    out.pop("ctrl_state")
    return out


def numpy_tree(x):
    """Tensors as numpy arrays, in dicts and lists: a rank returns no
    tensor (torch sends one through shared memory that dies with it)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [numpy_tree(v) for v in x]
    return x


def record(ts, metrics):
    """What a test holds of a TrainState after an update."""
    names = [n for n, _ in ts.network.named_parameters()]
    arr = lambda xs: {n: x.detach().numpy().copy() for n, x in
                      zip(names, xs)}
    return {"params": arr(ts.network.parameters()),
            "mu": arr(ts.opt_state.mu), "nu": arr(ts.opt_state.nu),
            "last_obs": ts.last_obs.numpy().copy(),
            "env": env_leaves(ts.env_state),
            "metrics": {k: v.numpy().copy() for k, v in metrics.items()},
            "update_idx": ts.update_idx, "count": ts.opt_state.count}


def sharded_run(mesh, cfg, task, p, path, start=None, d=None, seed=0):
    """One sharded update from `init` (or the weights `start`): its
    rank-local record (with the collectives it made), the gathered one,
    and its TrainState."""
    init, update, evaluate, _ = make_train(cfg, task, p, mesh=mesh,
                                           env_path=path)
    ts = init(torch.Generator().manual_seed(seed))
    if start is not None:
        ts.network.load_state_dict(start)
    before, bytes_before = mesh.collectives, mesh.collective_bytes
    calls, undo = counting_collectives()
    try:
        with profiling.recording() as spans:
            ts, m = make_sharded_update(update, mesh)(ts, d)
    finally:
        undo()
    local = dict(record(ts, m), collectives=mesh.collectives - before,
                 collective_bytes=mesh.collective_bytes - bytes_before,
                 dist_calls=list(calls), spans={
                     k: v for k, v in spans.summary().items()
                     if k.startswith("mesh.")})
    return local, record(gather_train_state(ts, mesh), m), ts


def single_run(cfg, task, p, path, d=None, seed=0):
    init, update, _, _ = make_train(cfg, task, p, device="cpu",
                                    env_path=path)
    ts, m = update(init(torch.Generator().manual_seed(seed)), d)
    return record(ts, m)


def case_jax(mesh, jax_inputs):
    """(a): from the JAX package's weights, on its replayed draws."""
    out = {}
    for name, (physics, path, start, noise, perms) in jax_inputs.items():
        cfg, task = config(physics)
        start = {k: torch.from_numpy(v) for k, v in start.items()}
        d = Draws(torch.from_numpy(noise), torch.from_numpy(perms))
        local, _, _ = sharded_run(mesh, cfg, task, ppo(), path, start, d)
        out[name] = dict(local, cols=mesh.env_range(E))
    return out


def case_single(mesh):
    """(b) and (e): sharded against one process, the same draws."""
    out = {}
    for name, path, task_kw, ppo_kw in (
            ("fused", "fused", {}, {}),
            ("batched_noise", "batched",
             {"reset_pos_noise": 0.2, "reset_rpy_noise": 0.1}, {}),
            ("sb3", "batched", {}, {"sb3_minibatching": True})):
        cfg, task = config(**task_kw)
        p = ppo(**ppo_kw)
        d = draws(1, n_perm=T * E if p.sb3_minibatching else T)
        local, gathered, ts = sharded_run(mesh, cfg, task, p, path, d=d)
        out[name] = {"sharded": gathered,
                     "collectives": local["collectives"],
                     "collective_record": {
                         k: local[k] for k in ("collectives",
                                               "collective_bytes",
                                               "dist_calls", "spans")},
                     "init": initial_shards(mesh, cfg, task, p, path)}
        if ts.reset_noise is not None:
            out[name]["noise_index"] = ts.reset_noise.index
        if mesh.rank == 0:
            out[name]["single"] = single_run(cfg, task, p, path, d)
    return out


def initial_shards(mesh, cfg, task, p, path):
    """The mesh's `init` against `shard_train_state` of one process's
    `init` from the same seed: two records, each with its reset noise's
    current block."""
    own = make_train(cfg, task, p, mesh=mesh, env_path=path)[0](
        torch.Generator().manual_seed(0))
    cut = shard_train_state(make_train(cfg, task, p, device="cpu",
                                       env_path=path)[0](
        torch.Generator().manual_seed(0)), mesh)
    return [dict(record(ts, {}), noise=None if ts.reset_noise is None
                 else ts.reset_noise.block.numpy().copy())
            for ts in (own, cut)]


def counting_collectives():
    """Wrap torch.distributed's collectives with a counter: ([count,
    bytes of the tensors they were given first], undo)."""
    calls = [0, 0]
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def wrap(fn):
        def counted(*args, **kwargs):
            calls[0] += 1
            if args and isinstance(args[0], torch.Tensor):
                calls[1] += args[0].numel() * args[0].element_size()
            return fn(*args, **kwargs)
        return counted
    for name, fn in saved.items():
        setattr(dist, name, wrap(fn))
    return calls, lambda: [setattr(dist, n, f) for n, f in saved.items()]


def case_population(mesh):
    """(c): K = 2 members over 2 ranks, against the unsharded update."""
    cfg, task = config()
    p = ppo()
    pinit, pupdate, _, _ = make_train_population(cfg, task, p, K,
                                                 device="cpu")
    d = draws(2, lead=(K,))
    ts = shard_population(pinit(torch.Generator().manual_seed(3)), mesh)
    update = make_sharded_population_update(pupdate, mesh)
    before = mesh.collectives
    calls, undo = counting_collectives()
    try:
        ts, m = update(ts, d)
    finally:
        undo()
    out = {"members": mesh.env_range(K), "mesh_collectives":
           mesh.collectives - before, "dist_calls": calls[0],
           "local": record(ts, m)}
    if mesh.rank == 0:
        full, fm = pupdate(pinit(torch.Generator().manual_seed(3)), d)
        out["single"] = record(full, fm)
    return out


def case_checkpoint(mesh, directory, path, task_kw, num_envs=E):
    """(d): saved at R = 2, resumed at R = 2 and at R = 1 (rank 0 alone);
    saved again at R = 1 and resumed at R = 2."""
    cfg, task = config(**task_kw)
    p = ppo(num_envs=num_envs)
    init, update, _, _ = make_train(cfg, task, p, mesh=mesh,
                                    env_path=path)
    fresh = lambda seed: init(torch.Generator().manual_seed(seed))
    directory = os.path.join(directory, path)
    ts, _ = update(fresh(0))
    f2 = save_checkpoint(os.path.join(directory, "r2.pt"), ts, mesh=mesh)
    gathered = record(gather_train_state(ts, mesh), {})
    a2 = record(*update(ts))
    r2 = record(*update(restore_checkpoint(f2, fresh(1), mesh)))
    out = {"gathered": gathered, "a2": a2, "r2": r2,
           "cols": mesh.env_range(num_envs)}
    if mesh.rank == 0:
        single_init, single_update, _, _ = make_train(
            cfg, task, p, device="cpu", env_path=path)
        one = restore_checkpoint(
            f2, single_init(torch.Generator().manual_seed(1)))
        out["r1_state"] = record(one, {})
        save_checkpoint(os.path.join(directory, "r1.pt"), one)
        out["b1"] = record(*single_update(one))
        out["files"] = [numpy_tree(torch.load(os.path.join(directory, f),
                                              weights_only=True))
                        for f in ("r2.pt", "r1.pt")]
    # every rank waits for rank 0's R = 1 file
    mesh.all_reduce(torch.zeros(1))
    back = restore_checkpoint(os.path.join(directory, "r1.pt"), fresh(2),
                              mesh)
    out["r1_to_r2"] = record(*update(back))
    return out


def run_cases(mesh, jax_inputs, directory):
    torch.set_num_threads(1)
    return {"rank": mesh.rank, "size": mesh.size,
            "jax": case_jax(mesh, jax_inputs),
            "single": case_single(mesh),
            "population": case_population(mesh),
            "checkpoint": {
                "batched_noise": case_checkpoint(
                    mesh, directory, "batched",
                    {"reset_pos_noise": 0.2, "reset_rpy_noise": 0.1}),
                # the fused path hands its obs out as a transposed view;
                # at 2 envs a rank a product of the policy rounds by the
                # layout of its operand
                "fused": case_checkpoint(mesh, directory, "fused", {},
                                         num_envs=4)}}
