"""The rollout driver: a closed loop over `make_fused_rollout`'s step.

Traffic parameters (`traffic/<mix>.json`): `num_envs`; `chunk`, the
control steps between two host readbacks (each chunk ends in a readback
of its summed reward and of the last obs's sum, which keeps the obs
live); `action_scale`, the scale of the N(0, 1) actions, drawn from the
seed on the device as one block of `chunk` steps in set-up and reused
cyclically; `free_steps`, the steps from the reset that the reference
follows on its own; `sampled_steps`, the steps of the window, drawn from
the seed among its first `sampled_chunks` chunks, that the reference
repeats from the program's carry; `sample_timeout` (optional), whether
the step at which the episodes that began at the reset time out (the
envs truncate and reset in the kernel) is always among them;
`trace_chunks`, the chunks of the profiled window of a traced run.

Set-up builds the env, the actions and two chunks of warm-up (the first
launch builds the kernels; the first chunk is the free-running check's).
The window then runs whole chunks until `--seconds` have passed and
every sampled step has run.
"""
from __future__ import annotations

import time

import numpy as np


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start):
    import torch
    from gym_pybullet_drones_tpu_torch.envs import fast

    from portbench import hostclock, port
    from portbench.counts import work
    from portbench.reference import ref_env
    from portbench.trace import Profiled

    tr = cell.traffic
    b, chunk = int(tr["num_envs"]), int(tr["chunk"])
    cfg, task = port.build(cell.config)
    n, a = cfg.num_drones, task.action_dim(cfg)
    reset_fn, step_fn = fast.make_fused_rollout(cfg, task, b,
                                                obs_layout="flat",
                                                device=device)
    gen = torch.Generator(device).manual_seed(seed)
    actions = float(tr["action_scale"]) * torch.randn(
        (chunk, b, n, a), generator=gen, device=device)

    def readback(rewards, obs):
        vals = torch.stack([torch.stack(rewards).sum(), obs.sum()]).tolist()
        if not np.isfinite(vals).all():
            raise FloatingPointError(f"non-finite reward or obs sum {vals}")

    # ---- set-up: reset, the free-running check's chunk, one more chunk
    carry, obs = reset_fn()
    start_obs = obs
    free_n = int(tr["free_steps"])
    free = []
    for c in range(2):
        rewards = []
        for t in range(chunk):
            carry, obs, rew, term, trunc = step_fn(carry, actions[t])
            rewards.append(rew)
            if c == 0 and t < free_n:
                free.append((carry, obs, rew, term, trunc))
        readback(rewards, obs)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(seed)
    n_pick = int(tr["sampled_steps"])
    picks = set()
    while len(picks) < n_pick:
        picks.add((int(rng.integers(0, int(tr["sampled_chunks"]))),
                   int(rng.integers(0, chunk))))
    if tr.get("sample_timeout"):
        # the window begins after the two chunks of set-up
        at = ref_env.make(cell.config).timeout_step() - 2 * chunk
        if at >= 0:
            picks.add(divmod(at, chunk))
    last_pick = max(c for c, _ in picks) if picks else -1
    kept = []

    # ---- the window: whole chunks until `seconds` have passed
    host_s = [] if traced else None
    chunks = 0
    usage = hostclock.Usage()
    t0 = time.perf_counter()
    while True:
        rewards = []
        for t in range(chunk):
            carry_in = carry
            if host_s is not None:
                h0 = time.perf_counter()
                carry, obs, rew, term, trunc = step_fn(carry, actions[t])
                host_s.append(time.perf_counter() - h0)
            else:
                carry, obs, rew, term, trunc = step_fn(carry, actions[t])
            rewards.append(rew)
            if (chunks, t) in picks:
                kept.append((t, carry_in, carry, obs, rew, term, trunc))
        readback(rewards, obs)
        chunks += 1
        usage.mark(chunks * chunk * b)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and chunks > last_pick:
            break
    host = usage.stop()
    steps = chunks * chunk
    e2e = {"env_steps_per_s": steps * b / elapsed, "setup_s": setup_s}

    ctx = {"env_steps_window": steps * b, "window_wall_s": elapsed,
           "host": host}
    ops, nbytes = work.env_step_work(cell.config)
    ctx["bound_s_per_step"] = work.bound_s(ops * b, nbytes * b)
    if traced:
        ctx["host_step_s"] = host_s
        with Profiled() as prof:
            for _ in range(int(tr["trace_chunks"])):
                rewards = []
                for t in range(chunk):
                    with prof.span("env_step"):
                        carry, obs, rew, term, trunc = step_fn(carry,
                                                               actions[t])
                    rewards.append(rew)
                readback(rewards, obs)
        ctx["trace"] = prof.trace
        ctx["env_steps_traced"] = int(tr["trace_chunks"]) * chunk
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0

    # ---- the check, once the window has closed: the reference on the
    # free-running start and on the sampled steps
    del carry, obs, rew, term, trunc, rewards
    numbers = verify(cell.config, b, actions, start_obs, free, kept, device)
    return {"e2e": e2e, "numbers": numbers, "attempted": steps * b,
            "failed": 0, "memory_peak_bytes": peak, "ctx": ctx}


def verify(config, b, actions, start_obs, free, kept, device):
    """The rollout numbers (`check.RolloutCompare`) of the program's
    outputs against the plain reference: its own reset and free-running
    steps for `free`, one step from the program's carry for each of
    `kept`."""
    import torch

    from portbench import check
    from portbench.reference import ref_env

    env = ref_env.make(config)
    ro = env.n * env.obs_rows_per
    dt = torch.float32
    cmp = check.RolloutCompare(ro)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            carry, obs_rows = env.reset(b, device, dt)
            cmp.outs_err = max(cmp.outs_err,
                               check.row_err(start_obs.t(), obs_rows, None))
            alive = None
            for t, (p_carry, p_obs, p_rew, p_term, p_trunc) in \
                    enumerate(free):
                carry, outs = env.step(carry, _rows(actions[t], dt))
                alive = cmp.step(p_carry, _outs(p_obs, p_rew, p_term,
                                                p_trunc),
                                 carry, outs, alive, env.nn_ties(carry))
            for t, c_in, p_carry, p_obs, p_rew, p_term, p_trunc in kept:
                r_carry, r_outs = env.step(c_in, _rows(actions[t], dt))
                cmp.step(p_carry, _outs(p_obs, p_rew, p_term, p_trunc),
                         r_carry, r_outs, None, env.nn_ties(r_carry))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return cmp.numbers()


def _rows(action, dtype):
    """(B, N, A) actions -> (N*A, B) drone-major rows."""
    b = action.shape[0]
    return action.reshape(b, -1).t().contiguous().to(dtype)


def _outs(obs, reward, term, trunc):
    """The program's outputs back as (RO, B) rows."""
    import torch
    return torch.cat([obs.t(), reward[None], term[None].float(),
                      trunc[None].float()])
