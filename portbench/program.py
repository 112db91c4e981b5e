"""The program's own records, read back for the per-layer metrics: its
spans (`gym_pybullet_drones_tpu_torch/utils/profiling.py` `span`) and the
kernels' load time (`_build.load_seconds`).

`context(ctx)` adds to a traced run's `ctx`, once, whatever of these keys
it lacks and can find:

- `kernel_load_s`: `_build.load_seconds` of this process, the first
  `load()` as a whole (the build, the five libraries' loads and their
  struct checks);
- `program_trace`: from a profiled window, per program span name, the
  span count, the device operations launched inside its spans and their
  device seconds (`attribute`); the training cell's own window profiles
  `PROFILED_UPDATES` updates;
- `program_spans`: the `summary()` of a window of the cell's work run
  under `profiling.recording()`, with no profiler and no hook, as large
  as the profiled one (`trace_updates` updates or `trace_chunks`
  chunks);
- `rollout_steps` and `optimize_steps` (`update_epochs x
  num_minibatches`) of a training cell, so that the per-step counts do
  not depend on spans inside a step.

`drivers/train.py` and `drivers/rollout.py` put none of them into
`ctx`.  Until their traced branches do, `context` takes the rollout
cell's profiled window from `ctx["trace"]`, which `drivers/rollout.py`
keeps, and runs the rest itself, after the check, for the cell and seed
of the run's own command line (`--workload`, `--seed`): the spans window
of either cell, and the training cell's profiled window, on a trainer
built as `drivers/train.py` builds its own (the benchmark's weights and
draws from the seed).  It runs nothing where the program records no
spans (a program older than its spans): the readers then find nothing
and return None.
"""
from __future__ import annotations

import bisect
import sys

from portbench.trace import merged

DONE = "program_context"      # the marker of a ctx that `context` filled
# the training cell's own profiled window: its launch counts are the same
# in every update, and the trace's export takes some 2 s an update
PROFILED_UPDATES = 2


def attribute(trace, names=None) -> dict:
    """{span name: {"spans", "ops", "device_s"}} of the trace's spans
    (all but the harness's `portbench.*` ones, or `names`): how many
    spans of that name, the device operations whose launch lies inside
    one of them (as `Trace.launched_in` decides it) and their summed
    device seconds.  One sort of the launches, then two bisections a
    span."""
    launches = sorted((at, (b - a) / 1e6) for (_, a, b, _), at in
                      zip(trace.device, trace.launched_at) if at is not None)
    times = [at for at, _ in launches]
    cum = [0.0]
    for _, dur in launches:
        cum.append(cum[-1] + dur)
    if names is None:
        names = [n for n in trace.spans if not n.startswith("portbench.")]
    out = {}
    for name in names:
        spans = trace.spans.get(name, [])
        ops, dev = 0, 0.0
        for lo, hi in merged(spans):
            i = bisect.bisect_left(times, lo)
            j = bisect.bisect_right(times, hi)
            ops += j - i
            dev += cum[j] - cum[i]
        out[name] = {"spans": len(spans), "ops": ops, "device_s": dev}
    return out


def _flag(argv, flag):
    for i, arg in enumerate(argv):
        if arg == flag and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith(flag + "="):
            return arg.split("=", 1)[1]
    return None


def run_of_argv(argv=None):
    """(cell, seed, device) of this process's `portbench.run` command
    line, or None where it names no workload or there is no card."""
    import torch

    from portbench import cell as cells
    argv = sys.argv[1:] if argv is None else argv
    workload, seed = _flag(argv, "--workload"), _flag(argv, "--seed")
    if workload is None or seed is None or not torch.cuda.is_available():
        return None
    return cells.load(workload), int(seed), "cuda:0"


def _profiling():
    """The program's profiling module where it records spans, else None."""
    from gym_pybullet_drones_tpu_torch.utils import profiling
    return profiling if hasattr(profiling, "recording") else None


def context(ctx: dict) -> dict:
    """`ctx` with the program's records that it lacks (module docstring),
    found once."""
    if ctx.get(DONE):
        return ctx
    ctx[DONE] = True
    from gym_pybullet_drones_tpu_torch import _build
    ctx.setdefault("kernel_load_s", getattr(_build, "load_seconds", None))
    profiling = _profiling()
    if profiling is None:
        return ctx
    trace = ctx.get("trace")
    if "program_trace" not in ctx and trace is not None and trace.device:
        ctx["program_trace"] = attribute(trace)
    run = None if "program_spans" in ctx else run_of_argv()
    if run is not None:
        cell = run[0]
        if cell.traffic["driver"] == "rollout":
            _rollout_window(ctx, *run, profiling)
        elif int(cell.traffic.get("ranks", 1)) == 1:
            # a sharded mix's spans are each rank's: none is run here
            _train_windows(ctx, *run, profiling)
    return ctx


def _rollout_window(ctx, cell, seed, device, profiling):
    import torch
    from gym_pybullet_drones_tpu_torch.envs import fast

    from portbench import port
    tr = cell.traffic
    b, chunk = int(tr["num_envs"]), int(tr["chunk"])
    cfg, task = port.build(cell.config)
    reset_fn, step_fn = fast.make_fused_rollout(cfg, task, b,
                                                obs_layout="flat",
                                                device=device)
    gen = torch.Generator(device).manual_seed(seed)
    actions = float(tr["action_scale"]) * torch.randn(
        (chunk, b, cfg.num_drones, task.action_dim(cfg)), generator=gen,
        device=device)
    carry, obs = reset_fn()

    def one_chunk(carry):
        rewards = []
        for t in range(chunk):
            carry, obs, rew, _, _ = step_fn(carry, actions[t])
            rewards.append(rew)
        torch.stack([torch.stack(rewards).sum(), obs.sum()]).tolist()
        return carry

    carry = one_chunk(carry)
    with profiling.recording() as record:
        for _ in range(int(tr["trace_chunks"])):
            carry = one_chunk(carry)
    ctx["program_spans"] = record.summary()


def _train_windows(ctx, cell, seed, device, profiling):
    import torch
    from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo

    from portbench import port
    from portbench.drivers import train as train_driver
    from portbench.trace import Profiled
    tr, config = cell.traffic, cell.config
    envs, steps = int(tr["num_envs"]), int(tr["rollout_steps"])
    epochs = int(config["ppo"]["update_epochs"])
    cfg, task = port.build(config)
    ppo = port.ppo_config(config, envs, steps)
    init, update, _, _ = port_ppo.make_train(cfg, task, ppo, device=device)
    ts = init(torch.Generator(device).manual_seed(seed))
    weights = train_driver.make_weights(config, seed, device)
    with torch.no_grad():
        for k, p in ts.network.named_parameters():
            p.copy_(weights[k])
    act_dim = cfg.num_drones * task.action_dim(cfg)
    gen = torch.Generator(device).manual_seed(
        seed ^ train_driver.NAMES_SEED_MIX)

    def one_update(ts):
        noise, perms = train_driver.make_draws(gen, steps, envs, act_dim,
                                               epochs, device)
        ts, metrics = update(ts, port_ppo.Draws(noise, perms))
        torch.stack(list(metrics.values())).tolist()
        return ts

    n = int(tr["trace_updates"])
    ts = one_update(ts)
    if "program_trace" not in ctx:
        with Profiled() as prof:
            for _ in range(min(n, PROFILED_UPDATES)):
                ts = one_update(ts)
        if prof.trace.device:
            ctx["program_trace"] = attribute(prof.trace)
    with profiling.recording() as record:
        for _ in range(n):
            ts = one_update(ts)
    ctx["program_spans"] = record.summary()
    ctx["rollout_steps"] = steps
    ctx["optimize_steps"] = epochs * ppo.num_minibatches


def record(ctx, key, name):
    """The program's record of span `name` under `key` of `ctx`
    (`program_trace` or `program_spans`, found by `context`), or None
    where no such span was recorded."""
    got = (context(ctx).get(key) or {}).get(name)
    if not got or not got.get("spans", got.get("count")):
        return None
    return got
