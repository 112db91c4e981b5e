"""The pixel training driver: a closed loop over `make_train`'s `update`
for a policy that sees camera images (the NatureCNN on the batched env
step: K1, the render kernel, the CNN's convolutions).

Traffic parameters (`traffic/<mix>.json`): `num_envs`, `rollout_steps`,
`ranks` (1 only), `check_updates` (the first updates, which the reference
follows), `window_check_within` (the window update that the reference
repeats is drawn from the seed among this many first ones), `check_rows`
(the rows of each rollout call of the policy that the check keeps: 32
images of 48x64x4 floats a call keep some 200 MB over the four checked
updates' 132 calls) and `trace_updates` (the updates of the profiled
window and of the spans window of a traced run).

As `drivers/train.py`: set-up builds the trainer, sets the policy's
weights to the benchmark's own (`make_weights`, made on the device from
the seed) and runs the first `check_updates` updates through the
window's own call on the benchmark's draws; the window runs whole
updates until `--seconds` have passed, each ending in a host readback of
its metrics; one window update, drawn from the seed, is kept with the
program's state before it (weights, Adam's moments, the env state and
observations) for the reference to repeat.  A `ForwardRecord` keeps rows
of the rollout's calls of the policy in the checked updates.  The
images checked are the observations the program holds for its policy at
three states it holds exactly: the reset, and before and after the kept
window update.

The traced branch profiles `trace_updates` updates, then runs as many
under `profiling.recording()` (no profiler), and puts into `ctx` what
`portbench/program.py` would otherwise look for: `program_trace`,
`program_spans`, `rollout_steps`, `optimize_steps` and `kernel_load_s`.
Everything stays on the one device; nothing crosses a process.
"""
from __future__ import annotations

import math
import time

from portbench.drivers.train import (
    NAMES_SEED_MIX, ForwardRecord, _p95, make_draws)


def make_weights(config: dict, seed: int, device) -> dict:
    """The NatureCNN's weights from the seed, on the device, in a few
    calls: every convolution and dense weight N(0, 1/fan_in) (the mean
    head's at a hundredth of it, as SB3's init scales its policy head),
    biases N(0, 0.01^2), log_std the configuration's."""
    import torch

    from portbench.reference.cnn import param_shapes
    shapes = param_shapes(config)
    names = [k for k in shapes if k != "log_std"]
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(shapes[k]) for k in names),
                       generator=gen, device=device)
    weights, at = {}, 0
    for k in names:
        size = math.prod(shapes[k])
        w = flat[at:at + size].reshape(shapes[k])
        at += size
        if k.endswith("bias"):
            w = 0.01 * w
        else:
            w = w / math.sqrt(math.prod(shapes[k][1:]))
            if k.startswith("mean."):
                w = 0.01 * w
        weights[k] = w.contiguous()
    weights["log_std"] = torch.full(shapes["log_std"], float(
        config["ppo"].get("log_std_init", 0.0)), device=device)
    return weights


def check_scene(config: dict) -> None:
    """Raise unless the port renders the configuration's scene and camera:
    its landmark scene, shading constants and image shape."""
    from gym_pybullet_drones_tpu_torch.ops import render

    sc, want = render.landmark_scene(), config["scene"]
    have = {
        "ambient": render.AMBIENT, "diffuse": render.DIFFUSE,
        "light_dir": list(render.LIGHT_DIR), "sky": list(render.SKY),
        "checker": list(render.CHECKER),
        "drone_color": list(render.DRONE_COLOR),
        "drone_id": render.DRONE_ID,
        "spheres": [{"center": list(c), "radius": r, "color": list(col),
                     "id": i} for c, r, col, i in zip(
                         sc.sphere_center, sc.sphere_radius,
                         sc.sphere_color, sc.sphere_id)],
        "boxes": [{"center": list(c), "half": list(h), "color": list(col),
                   "id": i} for c, h, col, i in zip(
                       sc.box_center, sc.box_half, sc.box_color,
                       sc.box_id)]}
    cam = config["camera"]
    shape = [int(cam["height"]), int(cam["width"]), int(cam["channels"])]
    if have != want or list(render.IMAGE_SHAPE) != shape \
            or shape != list(config["policy"]["image"]) \
            or render.FOV_DEG != cam["fov_deg"] or render.FAR != cam["far"]:
        raise ValueError("the port's camera and scene are not the "
                         "configuration's")


def env_state(s) -> dict:
    """The leaves of the program's flat env state `s` that the reference
    reads, cloned."""
    return {k: getattr(s, k).detach().clone() for k in (
        "pos", "quat", "vel", "rpy_rates", "ang_v", "last_rpm",
        "action_buffer", "step_counter")}


def _images(ts) -> dict:
    """The observations the trainer holds for its policy, and the state
    they are of."""
    return {"obs": ts.last_obs.detach().clone(),
            "pos": ts.env_state.pos.detach().clone(),
            "quat": ts.env_state.quat.detach().clone()}


def build(cell, seed: int, device):
    """(update, ts, named parameters) of the program's trainer for the
    cell, at the benchmark's weights."""
    import torch
    from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo

    from portbench import port
    tr, config = cell.traffic, cell.config
    if int(tr.get("ranks", 1)) != 1:
        raise ValueError("drivers/train_rgb.py runs one rank")
    check_scene(config)
    cfg, task = port.build(config)
    ppo = port_ppo.PPOConfig(num_envs=int(tr["num_envs"]),
                             rollout_steps=int(tr["rollout_steps"]),
                             **config["ppo"])
    init, update, _, _ = port_ppo.make_train(cfg, task, ppo, device=device)
    if update.env_path != "batched":
        raise ValueError(f"the pixel trainer steps its env on the "
                         f"{update.env_path} path")
    ts = init(torch.Generator(device).manual_seed(seed))
    weights = make_weights(config, seed, device)
    named = dict(ts.network.named_parameters())
    if sorted(named) != sorted(weights):
        raise ValueError(f"the port's policy has parameters {sorted(named)}, "
                         f"the benchmark makes {sorted(weights)}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(weights[k])
    return update, ts, named


def train_loop(cell, seed: int, seconds: float, traced: bool, device,
               t_start_wall: float) -> dict:
    """Set-up, check updates, window and trace: the timings, the check
    record (tensors on the device) and, traced, the program's records."""
    import numpy as np
    import torch
    from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo

    from portbench import hostclock
    from portbench.counts import pixels

    tr, config = cell.traffic, cell.config
    envs, steps = int(tr["num_envs"]), int(tr["rollout_steps"])
    epochs = int(config["ppo"]["update_epochs"])
    update, ts, named = build(cell, seed, device)
    order = list(named)
    act_dim = int(ts.network.action_dim)
    gen = torch.Generator(device).manual_seed(seed ^ NAMES_SEED_MIX)

    def draws():
        return port_ppo.Draws(*make_draws(gen, steps, envs, act_dim, epochs,
                                          device))

    def read(metrics):
        vals = {k: float(v) for k, v in zip(
            metrics, torch.stack(list(metrics.values())).tolist())}
        if not all(math.isfinite(v) for v in vals.values()):
            raise FloatingPointError(f"non-finite metrics {vals}")
        return vals

    def moments(which):
        return {k: m.detach().clone() for k, m in zip(order, which)}

    record = ForwardRecord(ts.network, seed, int(tr["check_rows"]), device)

    # ---- set-up: the checked updates, through the window's own call
    start = {k: p.detach().clone() for k, p in named.items()}
    check = {"metrics": [], "images": [_images(ts)]}
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
    setup_s = time.time() - t_start_wall

    # ---- the window
    u_check = int(np.random.default_rng(seed).integers(
        0, int(tr["window_check_within"])))
    update_s = []
    usage = hostclock.Usage()
    t0 = time.perf_counter()
    while True:
        u0 = time.perf_counter()
        d = draws()
        if len(update_s) == u_check:
            win = {"params": {k: p.detach().clone()
                              for k, p in named.items()},
                   "mu": moments(ts.opt_state.mu),
                   "nu": moments(ts.opt_state.nu),
                   "count": ts.opt_state.count,
                   "state": env_state(ts.env_state),
                   "obs": ts.last_obs.clone(),
                   "noise": d.noise, "perms": d.perms}
            check["images"].append(_images(ts))
            before = len(record.calls)
            with record:
                ts, metrics = update(ts, d)
            win["metrics"] = read(metrics)
            record.checked(ts, before)
            win["change"] = {k: p.detach() - win["params"][k]
                             for k, p in named.items()}
            win["mu_after"] = moments(ts.opt_state.mu)
            check["images"].append(_images(ts))
            check["window"] = win
        else:
            ts, metrics = update(ts, d)
            read(metrics)
        u1 = time.perf_counter()
        update_s.append(u1 - u0)
        usage.mark(len(update_s) * envs * steps)
        if u1 - t0 >= seconds and len(update_s) > u_check:
            break
    elapsed = time.perf_counter() - t0
    host = usage.stop()
    check["calls"] = record.calls
    out = {"setup_s": setup_s, "update_s": update_s, "elapsed": elapsed,
           "updates": len(update_s), "env_steps": len(update_s) * envs
           * steps, "host": host, "check": check,
           "update_flops": pixels.update_flops(config, envs, steps)}
    if traced:
        out.update(_trace_windows(update, ts, draws, read,
                                  int(tr["trace_updates"])))
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    return out


def _trace_windows(update, ts, draws, read, n: int) -> dict:
    """The profiled window of `n` updates and the spans window of as many
    (`profiling.recording()`, no profiler): the trace's summary and the
    program's records."""
    from gym_pybullet_drones_tpu_torch import _build
    from gym_pybullet_drones_tpu_torch.utils import profiling

    from portbench import program
    from portbench.trace import Profiled
    with Profiled() as prof:
        for _ in range(n):
            with prof.span("update"):
                ts, metrics = update(ts, draws())
                read(metrics)
    with profiling.recording() as rec:
        for _ in range(n):
            ts, metrics = update(ts, draws())
            read(metrics)
    t = prof.trace
    return {"trace": {"busy_s": t.busy_us() / 1e6,
                      "window_s": t.window_us / 1e6,
                      "breakdown": {"device_ops": t.top_device_ops(10),
                                    "idle_gaps": t.idle_gaps(10)}},
            "program_trace": program.attribute(t),
            "program_spans": rec.summary(),
            "kernel_load_s": getattr(_build, "load_seconds", None)}


def run(cell, seed: int, seconds: float, traced: bool, device, t_start):
    from portbench.counts import pixels

    t_start_wall = time.time() - (time.perf_counter() - t_start)
    out = train_loop(cell, seed, seconds, traced, device, t_start_wall)
    tr, config = cell.traffic, cell.config
    cameras = int(tr["num_envs"]) * int(config["env"]["num_drones"])
    e2e = {"train_env_steps_per_s": out["env_steps"] / out["elapsed"],
           "update_ms_p95": 1e3 * _p95(out["update_s"]),
           "setup_s": out["setup_s"]}
    ctx = {"window_wall_s": out["elapsed"], "updates_window": out["updates"],
           "update_flops": out["update_flops"], "host": out["host"]}
    result = {"e2e": e2e, "ctx": ctx, "attempted": out["updates"],
              "failed": 0, "memory_peak_bytes": out["memory_peak_bytes"]}
    if traced:
        ctx.update(
            program_trace=out["program_trace"],
            program_spans=out["program_spans"],
            kernel_load_s=out["kernel_load_s"],
            rollout_steps=int(tr["rollout_steps"]),
            optimize_steps=int(config["ppo"]["update_epochs"])
            * int(config["ppo"]["num_minibatches"]),
            render_bound_s=pixels.render_bound_s(cameras, config),
            dyn_bound_s=pixels.k1_bound_s(cameras, config))
        result["trace_info"] = out["trace"]
    result["numbers"] = verify(cell, seed, out["check"], device)
    return result


def verify(cell, seed: int, prog: dict, device, look=None) -> dict:
    """The numbers that decide `correct`: `check.train_numbers`' three of
    the checked updates against the plain reference's (the first updates
    from the same weights and draws, the window update from the program's
    state before it), `check_rgb`'s `policy_gap` of the kept calls and
    `image_err` / `image_tie_share` of the kept images.  `look`, a dict,
    gets each update's loss gap for the calibration."""
    from portbench import check, check_rgb
    ppo = cell.config["ppo"]
    ref = reference_updates(cell, seed, device)
    ref_win = reference_window(cell, prog["window"], device)
    numbers = check.train_numbers(
        {k: prog[k] for k in ("metrics", "mu1", "change", "window")},
        ref, ppo, ref_win)
    if look is not None:
        look["loss_gaps"] = check.loss_gaps(prog, ref, ppo) \
            + check.loss_gaps({"metrics": [prog["window"]["metrics"]]},
                              {"metrics": [ref_win["metrics"]]}, ppo)
    numbers["policy_gap"] = check_rgb.policy_gap(
        prog["calls"], cell.config, device) if prog["calls"] else math.inf
    numbers.update(check_rgb.image_numbers(prog["images"], cell.config,
                                           device))
    return numbers


def reference_updates(cell, seed: int, device) -> dict:
    """The plain reference's first `check_updates` updates from the
    benchmark's weights and draws: {"metrics", "mu1", "change"}."""
    import torch

    from portbench.reference import cnn as ref_cnn
    tr, config = cell.traffic, cell.config
    envs, steps = int(tr["num_envs"]), int(tr["rollout_steps"])
    env = ref_cnn.RgbEnv(config)
    weights = make_weights(config, seed, device)
    gen = torch.Generator(device).manual_seed(seed ^ NAMES_SEED_MIX)
    ref = ref_cnn.RefTrainer(env, config["ppo"], weights, envs, 0, device)
    metrics = []
    for u in range(int(tr["check_updates"])):
        noise, perms = make_draws(gen, steps, envs, env.act_dim,
                                  int(config["ppo"]["update_epochs"]),
                                  device)
        metrics.append(ref.update(noise, perms))
        if u == 0:
            mu1 = {k: v.clone() for k, v in ref.mu.items()}
    change = {k: ref.params[k] - weights[k] for k in ref.params}
    return {"metrics": metrics, "mu1": mu1, "change": change}


def reference_window(cell, win: dict, device) -> dict:
    """The plain reference's repeat of the kept window update from the
    program's state before it, on that update's draws: {"metrics",
    "change", "mu_after"}."""
    from portbench.reference import cnn as ref_cnn
    env = ref_cnn.RgbEnv(cell.config)
    state = dict(win, carry=env.carry_of(win["state"]))
    ref = ref_cnn.RefTrainer.from_state(env, cell.config["ppo"], state, 0,
                                        device)
    metrics = ref.update(win["noise"], win["perms"])
    change = {k: ref.params[k] - win["params"][k] for k in ref.params}
    return {"metrics": metrics, "change": change, "mu_after": ref.mu}

