"""The training driver: a closed loop over `make_train`'s `update`.

Traffic parameters (`traffic/<mix>.json`): `num_envs` (envs a rank),
`rollout_steps`, `ranks` (1: one process; R > 1: R processes, one card
each, over NCCL, through `parallel.launch.run_ranks` and
`make_train(mesh=)`, the global batch `ranks x num_envs`),
`check_updates` (the first updates, which the reference follows),
`window_check_within` (the window update that the reference repeats is
drawn from the seed among this many first ones), `check_rows` (the rows
of each policy call that the check keeps) and `trace_updates` (the
profiled updates of a traced run).

Set-up builds the trainer, sets the policy's weights to the benchmark's
own (made on the device from the seed, `make_weights`), and runs the
first `check_updates` updates through the window's own call, each on the
benchmark's draws (`make_draws`: the rollout noise and one permutation of
the time steps an epoch, from a generator seeded by the seed); they warm
every shape up.  The window then runs whole updates until `--seconds`
have passed, each ending in a host readback of its metrics.  Before one
window update, drawn from the seed, the driver keeps the program's state
(weights, Adam's moments, the env carry and observations) and that
update's draws, so that the reference can repeat it.

During the checked updates (set-up's and that window update) a
`ForwardRecord` on the program's policy module keeps rows of every call
the update makes: what the rollout's and the minibatch steps' forward
passes computed, at the precision the program computed them in.
"""
from __future__ import annotations

import math
import statistics
import time

NAMES_SEED_MIX = 0x5DEECE66D   # the draws' generator: another stream
ROWS_SEED_MIX = 0x2545F491     # the kept rows' generator: a third


def make_weights(config: dict, seed: int, device) -> dict:
    """The policy's weights from the seed, on the device, in a few calls:
    every matrix N(0, 1/fan_in) (the heads' at a hundredth of it for the
    mean, as SB3's init scales its policy head), biases N(0, 0.01^2),
    log_std the configuration's."""
    import torch

    from portbench.counts.work import act_width, obs_width
    from portbench.reference.ppo import param_names
    obs, act = obs_width(config), act_width(config)
    hidden = list(config["policy"]["hidden"])
    shapes = {}
    for tower, head, out in (("pi", "mean", act), ("vf", "value", 1)):
        widths = [obs] + hidden
        for i in range(len(hidden)):
            shapes[f"{tower}.{i}.weight"] = (widths[i + 1], widths[i])
            shapes[f"{tower}.{i}.bias"] = (widths[i + 1],)
        shapes[f"{head}.weight"] = (out, widths[-1])
        shapes[f"{head}.bias"] = (out,)
    names = param_names(len(hidden))[:-1]
    gen = torch.Generator(device).manual_seed(seed)
    total = sum(math.prod(shapes[k]) for k in names)
    flat = torch.randn(total, generator=gen, device=device)
    weights, at = {}, 0
    for k in names:
        size = math.prod(shapes[k])
        w = flat[at:at + size].reshape(shapes[k])
        at += size
        if k.endswith("bias"):
            w = 0.01 * w
        else:
            w = w / math.sqrt(shapes[k][1])
            if k.startswith("mean."):
                w = 0.01 * w
        weights[k] = w.contiguous()
    weights["log_std"] = torch.full((act,), float(
        config["ppo"].get("log_std_init", 0.0)), device=device)
    return weights


def make_draws(gen, steps: int, envs: int, act_dim: int, epochs: int,
               device):
    """One update's draws: the rollout noise (steps, envs, act_dim) and
    one permutation of the time steps an epoch (epochs, steps)."""
    import torch
    noise = torch.randn((steps, envs, act_dim), generator=gen, device=device)
    perms = torch.stack([torch.randperm(steps, generator=gen, device=device)
                         for _ in range(epochs)])
    return noise, perms


class ForwardRecord:
    """Rows of every call of a policy module while the record is entered:
    the input rows, the Gaussian mean and the value that the call returned
    for them, and the module's weights at that call (cloned again only
    when an in-place step has changed them).  The rows are drawn from the
    seed, the same for every call of one batch size."""

    def __init__(self, net, seed: int, rows: int, device):
        import torch
        self.net, self.rows, self.device = net, rows, device
        self.gen = torch.Generator(device).manual_seed(seed ^ ROWS_SEED_MIX)
        self.index, self.calls = {}, []
        self._versions = self._weights = self._pending = None
        self._handles = []

    def __enter__(self):
        self._handles = [self.net.register_forward_pre_hook(self._pre),
                         self.net.register_forward_hook(self._post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _pre(self, module, args):
        import torch
        x = args[0].detach()
        x = x.reshape(-1, x.shape[-1])
        m = x.shape[0]
        if m not in self.index:
            self.index[m] = torch.randperm(
                m, generator=self.gen, device=self.device)[:self.rows]
        params = list(module.named_parameters())
        versions = tuple(p._version for _, p in params)
        if versions != self._versions:
            self._weights = {k: p.detach().clone() for k, p in params}
            self._versions = versions
        idx = self.index[m]
        self._pending = (self._weights, x[idx], idx)

    def _post(self, module, args, out):
        weights, x, idx = self._pending
        mean, value = out[0].detach(), out[2].detach()
        self.calls.append({"weights": weights, "obs": x,
                           "mean": mean.reshape(-1, mean.shape[-1])[idx],
                           "value": value.reshape(-1)[idx]})

    def checked(self, ts, before: int):
        """After an update that began with `before` calls kept: where the
        update made no call that the record saw, the module is called
        once on the observations the update left, at the weights it left,
        so that a precision the program keeps still shows."""
        import torch
        if len(self.calls) == before:
            with self, torch.no_grad():
                self.net(ts.last_obs[None])


def to_host(obj):
    """A record with every tensor as a float32 (or integer) numpy array,
    so that a rank can return it."""
    import torch
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_host(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.is_floating_point() and t.dtype != torch.float64:
            t = t.float()
        return t.cpu().numpy()
    return obj


def as_tensors(obj):
    """`to_host`'s record with its arrays back as CPU tensors."""
    import numpy as np
    import torch
    if isinstance(obj, dict):
        return {k: as_tensors(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [as_tensors(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    return obj


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def train_loop(mesh, cell, seed: int, seconds: float, traced: bool,
               device, t_start_wall: float, precision=None) -> dict:
    """One rank's set-up, check updates, window and trace; numbers and
    numpy only, so that a rank can return it.  `precision` switches on a
    lower precision than the configuration's, for the controls that the
    calibration reads: "bfloat16" the program's own bfloat16 policy
    (`PPOConfig.compute_dtype`), "tf32" TF32 matrix products around every
    call of the program.  Otherwise the program runs as the configuration
    states: float32 with TF32 off."""
    import torch
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        return _train_loop(mesh, cell, seed, seconds, traced, device,
                           t_start_wall, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _train_loop(mesh, cell, seed, seconds, traced, device, t_start_wall,
                precision):
    import numpy as np
    import torch
    import torch.distributed as dist
    from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo

    from portbench import hostclock, port
    from portbench.counts import work
    from portbench.trace import Profiled

    tr, config = cell.traffic, cell.config
    ranks = 1 if mesh is None else mesh.size
    if mesh is not None:
        device = mesh.device
    e_global = int(tr["num_envs"]) * ranks
    steps = int(tr["rollout_steps"])
    cfg, task = port.build(config)
    ppo = port.ppo_config(config, e_global, steps,
                          "bfloat16" if precision == "bfloat16" else None)
    init, update, _, _ = port_ppo.make_train(cfg, task, ppo, device=device,
                                             mesh=mesh)
    ts = init(torch.Generator(device).manual_seed(seed))
    if not isinstance(ts.env_state, torch.Tensor):
        raise ValueError("the trainer steps its env on the batched path; "
                         "the reference resumes from the fused carry")
    weights = make_weights(config, seed, device)
    named = dict(ts.network.named_parameters())
    if sorted(named) != sorted(weights):
        raise ValueError(f"the port's policy has parameters {sorted(named)}, "
                         f"the benchmark makes {sorted(weights)}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(weights[k])
    order = list(named)
    act_dim = cfg.num_drones * task.action_dim(cfg)
    gen = torch.Generator(device).manual_seed(seed ^ NAMES_SEED_MIX)

    def draws():
        noise, perms = make_draws(gen, steps, e_global, act_dim,
                                  int(config["ppo"]["update_epochs"]),
                                  device)
        return port_ppo.Draws(noise, perms)

    def read(metrics):
        vals = {k: float(v) for k, v in zip(
            metrics, torch.stack(list(metrics.values())).tolist())}
        if not all(math.isfinite(v) for v in vals.values()):
            raise FloatingPointError(f"non-finite metrics {vals}")
        return vals

    def moments(which):
        return {k: m.detach().clone() for k, m in zip(order, which)}

    record = ForwardRecord(ts.network, seed, int(tr.get("check_rows", 256)),
                           device)

    # ---- set-up: the checked updates, through the window's own call
    start = {k: p.detach().clone() for k, p in named.items()}
    check = {"metrics": []}
    for u in range(int(tr["check_updates"])):
        before = len(record.calls)
        with record:
            ts, metrics = update(ts, draws())
        record.checked(ts, before)
        check["metrics"].append(read(metrics))
        if u == 0:
            check["mu1"] = moments(ts.opt_state.mu)
    check["change"] = {k: p.detach() - start[k] for k, p in named.items()}
    del start
    _sync(device)
    setup_s = time.time() - t_start_wall

    stop = torch.zeros(1, device=device)

    def done(elapsed):
        # every rank stops after the same update: the ranks' collectives
        # pair up update by update
        if mesh is None:
            return elapsed >= seconds
        stop.fill_(1.0 if elapsed >= seconds else 0.0)
        dist.all_reduce(stop)
        return float(stop) > 0

    # ---- the window: whole updates until `seconds` have passed (and the
    # update that the reference repeats has run)
    u_check = int(np.random.default_rng(seed).integers(
        0, int(tr.get("window_check_within", 8))))
    update_s, rollout_s, optimize_s = [], [], []
    marks = []

    def mark():
        _sync(device)
        marks.append(time.perf_counter())

    usage = hostclock.Usage()
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        marks.clear()
        d = draws()
        hook = mark if traced else None
        if len(update_s) == u_check:
            win = {"params": {k: p.detach().clone()
                              for k, p in named.items()},
                   "mu": moments(ts.opt_state.mu),
                   "nu": moments(ts.opt_state.nu),
                   "count": ts.opt_state.count,
                   "carry": ts.env_state.clone(),
                   "obs": ts.last_obs.clone(),
                   "noise": d.noise, "perms": d.perms}
            before = len(record.calls)
            with record:
                ts, metrics = update(ts, d, after_rollout=hook)
            win["metrics"] = read(metrics)
            record.checked(ts, before)
            win["change"] = {k: p.detach() - win["params"][k]
                             for k, p in named.items()}
            win["mu_after"] = moments(ts.opt_state.mu)
            check["window"] = win
        else:
            ts, metrics = update(ts, d, after_rollout=hook)
            read(metrics)
        u1 = time.perf_counter()
        update_s.append(u1 - u0)
        usage.mark(len(update_s) * e_global * steps)
        if traced:
            rollout_s.append(marks[0] - u0)
            optimize_s.append(u1 - marks[0])
        if done(u1 - t0) and len(update_s) > u_check:
            break
    elapsed = time.perf_counter() - t0
    host = usage.stop()
    check["calls"] = record.calls
    n_up = len(update_s)
    out = {"setup_s": setup_s, "update_s": update_s, "elapsed": elapsed,
           "updates": n_up, "env_steps": n_up * e_global * steps,
           "rank": 0 if mesh is None else mesh.rank, "host": host}
    if traced:
        out["rollout_s"], out["optimize_s"] = rollout_s, optimize_s
        n_tr = int(tr["trace_updates"])
        with Profiled() as prof:
            for _ in range(n_tr):
                with prof.span("update"):
                    ts, metrics = update(ts, draws())
                    read(metrics)
        t = prof.trace
        out["trace"] = {
            "busy_s": t.busy_us() / 1e6, "window_s": t.window_us / 1e6,
            "device_ops": len(t.device),
            "breakdown": {"device_ops": t.top_device_ops(10),
                          "idle_gaps": t.idle_gaps(10)}}
    out["update_flops"] = work.update_flops(config, e_global, steps)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    out["check"] = to_host(check)
    return out


def rank_main(mesh, cell, seed, seconds, traced, t_start_wall):
    """What one rank of a sharded cell runs (`run_ranks`)."""
    return train_loop(mesh, cell, seed, seconds, traced, None, t_start_wall)


def merged_check(outs) -> dict:
    """Rank 0's check record with the window state of every rank's envs
    (the carry's columns, the observations' rows, in rank order) and
    every rank's kept policy calls."""
    import numpy as np
    check = outs[0]["check"]
    if len(outs) > 1:
        wins = [o["check"]["window"] for o in outs]
        check["window"]["carry"] = np.concatenate([w["carry"] for w in wins],
                                                  axis=1)
        check["window"]["obs"] = np.concatenate([w["obs"] for w in wins],
                                                axis=0)
        check["calls"] = [c for o in outs for c in o["check"]["calls"]]
    return check


def run(cell, seed: int, seconds: float, traced: bool, device, t_start):
    import torch
    ranks = int(cell.traffic.get("ranks", 1))
    t_start_wall = time.time() - (time.perf_counter() - t_start)
    if ranks == 1:
        outs = [train_loop(None, cell, seed, seconds, traced, device,
                           t_start_wall)]
    else:
        from gym_pybullet_drones_tpu_torch.parallel import launch
        on_cpu = torch.device(device).type == "cpu"
        outs = launch.run_ranks(
            rank_main, ranks, "gloo" if on_cpu else "nccl",
            args=(cell, seed, seconds, traced, t_start_wall),
            device="cpu" if on_cpu else None, timeout_s=600)
    r0 = outs[0]
    e2e = {"train_env_steps_per_s": r0["env_steps"] / r0["elapsed"],
           "update_ms_p95": 1e3 * _p95(r0["update_s"]),
           "setup_s": max(o["setup_s"] for o in outs)}
    ctx = {"window_wall_s": r0["elapsed"], "updates_window": r0["updates"],
           "update_flops": r0["update_flops"], "cards": ranks,
           "host": r0["host"]}
    result = {"e2e": e2e, "ctx": ctx, "attempted": r0["updates"],
              "failed": 0,
              "memory_peak_bytes": max(o["memory_peak_bytes"] for o in outs)}
    if traced:
        ctx["rollout_s"], ctx["optimize_s"] = r0["rollout_s"], \
            r0["optimize_s"]
        result["trace_info"] = {
            "busy_s": statistics.fmean(o["trace"]["busy_s"] for o in outs),
            "window_s": r0["trace"]["window_s"],
            "breakdown": r0["trace"]["breakdown"]}
        if all(o["trace"]["device_ops"] for o in outs):
            ctx["device_idle_share"] = 1.0 - result["trace_info"]["busy_s"] \
                / result["trace_info"]["window_s"]
    prog = as_tensors(merged_check(outs))
    del outs
    result["numbers"] = verify(cell, seed, prog, device)
    return result


def _p95(values) -> float:
    """The 95th percentile (statistics' exclusive method, n >= 2)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


def verify(cell, seed: int, prog: dict, device) -> dict:
    """The training numbers (`check.train_numbers`) of the program's
    checked updates against the plain reference's: the first updates from
    the same weights and draws, the window update from the program's
    state before it, and every kept policy call on its own rows and
    weights."""
    from portbench import check
    return check.train_numbers(
        prog, reference_updates(cell, seed, device), cell.config["ppo"],
        reference_window(cell, prog["window"], device),
        len(cell.config["policy"]["hidden"]), device)


def _reference_env(cell):
    from portbench.reference import ref_env
    return ref_env.make(cell.config)


def reference_updates(cell, seed: int, device, drop_half=False,
                      shard=None) -> dict:
    """The plain reference's first `check_updates` updates from the
    benchmark's weights and draws: {"metrics": [a dict an update], "mu1":
    Adam's first moments after the first, "change": the parameters'
    change (these on the CPU), "dones": each rollout step's done flags}.
    `drop_half` and `shard` (only the first of `shard` equal parts of the
    envs) plant the faults that the calibration reads: half of each
    minibatch left out, and the exchange between the ranks left out."""
    import torch

    from portbench.reference.ppo import RefTrainer

    tr, config = cell.traffic, cell.config
    e_global = int(tr["num_envs"]) * int(tr.get("ranks", 1))
    steps = int(tr["rollout_steps"])
    env = _reference_env(cell)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        weights = make_weights(config, seed, device)
        gen = torch.Generator(device).manual_seed(seed ^ NAMES_SEED_MIX)
        e_ref = e_global if shard is None else e_global // shard
        ref = RefTrainer(env, config["ppo"], weights, e_ref,
                         len(config["policy"]["hidden"]), device,
                         drop_half=drop_half)
        metrics = []
        for u in range(int(tr["check_updates"])):
            noise, perms = make_draws(gen, steps, e_global,
                                      env.act_dim * env.n,
                                      int(config["ppo"]["update_epochs"]),
                                      device)
            metrics.append(ref.update(noise[:, :e_ref], perms))
            if u == 0:
                mu1 = {k: v.cpu() for k, v in ref.mu.items()}
        change = {k: (ref.params[k] - weights[k]).cpu() for k in ref.params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"metrics": metrics, "mu1": mu1, "change": change,
            "dones": ref.dones}


def reference_window(cell, win: dict, device, drop_half=False) -> dict:
    """The plain reference's repeat of the kept window update from the
    program's state before it, on that update's draws: {"metrics",
    "change", "mu_after"} (on the CPU)."""
    import torch

    from portbench.reference.ppo import RefTrainer

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = RefTrainer.from_state(
            _reference_env(cell), cell.config["ppo"], win,
            len(cell.config["policy"]["hidden"]), device, drop_half)
        metrics = ref.update(win["noise"].to(device),
                             win["perms"].to(device))
        change = {k: (ref.params[k] - win["params"][k].to(device)).cpu()
                  for k in ref.params}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"metrics": metrics, "change": change,
            "mu_after": {k: v.cpu() for k, v in ref.mu.items()}}
