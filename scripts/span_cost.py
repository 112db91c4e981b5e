#!/usr/bin/env python3
"""What the port's spans (`utils/profiling.span`) cost, and that they
change no output.

    python3 scripts/span_cost.py [--pairs 3] [--updates 12] [--chunks 24]

Needs one CUDA card.  Runs the benchmark's two cells' work (`portbench`:
`hover_dyn` PPO updates of 8192 envs x 64 steps, 4 x 4, on the
benchmark's weights and draws; `routing4_pyb` 64-step chunks of 16384
fleets of 4) and prints one JSON line each:

- `span_ns`: nanoseconds a `with span(...)` costs on this host in each
  state: off, recorded (inside `recording()`), under `torch.profiler`,
  and both; beside a `with` on a no-op object of C methods (the floor of
  a `with` statement here);
- `update_bit_for_bit`: one training update from the same weights, env
  and draws with tracing off, and with `recording()` and the profiler
  on: its weights, Adam's moments, env carry and metrics compared with
  `torch.equal`;
- `train_rate`, `rollout_rate`: each cell's env-steps/s with
  `recording()` on for the whole turn against off, in turns off, on, on,
  off (`--pairs` times), each turn `--updates` updates or `--chunks`
  chunks ending in a readback;
- `card`: the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import timeit

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gym_pybullet_drones_tpu_torch.envs import fast  # noqa: E402
from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo  # noqa: E402
from gym_pybullet_drones_tpu_torch.utils import profiling  # noqa: E402
from portbench import port  # noqa: E402
from portbench.drivers import train as train_driver  # noqa: E402

DEVICE = "cuda:0"
SEED = 2 ** 31 + 16


def read_json(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


def config(name):
    return read_json("configs", name + ".json")


def traffic(name):
    return read_json("traffic", name + ".json")


def span_ns():
    """ns a `with span(...): pass` costs in each state (best of 5)."""
    def cost(n):
        return min(timeit.repeat("with span('ppo.rollout'): pass",
                                 globals={"span": profiling.span},
                                 number=n, repeat=5)) / n * 1e9
    out = {"off": cost(200_000),
           "c_no_op_with": min(timeit.repeat(
               "with off: pass", globals={"off": profiling.OFF},
               number=200_000, repeat=5)) / 200_000 * 1e9}
    with profiling.recording():
        out["recorded"] = cost(20_000)
    # the profiler's exit takes about a millisecond an event to process:
    # few spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["profiler"] = cost(1_000)
        with profiling.recording():
            out["profiler_and_recorded"] = cost(1_000)
    return out


def trainer():
    """(state, one_update(ts, gen) -> ts, metrics, new_gen(), env steps
    an update) of the training cell's configuration."""
    cfg_json, tr = config("hover_dyn"), traffic("train8192")
    envs, steps = int(tr["num_envs"]), int(tr["rollout_steps"])
    epochs = int(cfg_json["ppo"]["update_epochs"])
    cfg, task = port.build(cfg_json)
    ppo = port.ppo_config(cfg_json, envs, steps)
    init, update, _, _ = port_ppo.make_train(cfg, task, ppo, device=DEVICE)
    act_dim = cfg.num_drones * task.action_dim(cfg)

    def fresh():
        ts = init(torch.Generator(DEVICE).manual_seed(SEED))
        weights = train_driver.make_weights(cfg_json, SEED, DEVICE)
        with torch.no_grad():
            for k, p in ts.network.named_parameters():
                p.copy_(weights[k])
        return ts

    def new_gen():
        return torch.Generator(DEVICE).manual_seed(
            SEED ^ train_driver.NAMES_SEED_MIX)

    def one_update(ts, gen):
        noise, perms = train_driver.make_draws(gen, steps, envs, act_dim,
                                               epochs, DEVICE)
        ts, metrics = update(ts, port_ppo.Draws(noise, perms))
        torch.stack(list(metrics.values())).tolist()
        return ts, metrics

    return fresh, one_update, new_gen, envs * steps


def update_bit_for_bit(fresh, one_update, new_gen):
    ts_off, m_off = one_update(fresh(), new_gen())
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]), profiling.recording():
        ts_on, m_on = one_update(fresh(), new_gen())
    same = lambda xs, ys: all(torch.equal(a, b) for a, b in zip(xs, ys))
    return {"weights": same(ts_off.network.parameters(),
                            ts_on.network.parameters()),
            "adam": same(ts_off.opt_state.mu + ts_off.opt_state.nu,
                         ts_on.opt_state.mu + ts_on.opt_state.nu),
            "env": torch.equal(ts_off.env_state, ts_on.env_state),
            "metrics": all(torch.equal(m_off[k], m_on[k]) for k in m_off)}


def turns(run_turn, pairs):
    """Rates of turns off, on, on, off, ... (`pairs` times)."""
    rates = {"off": [], "on": []}
    for _ in range(pairs):
        for state in ("off", "on", "on", "off"):
            if state == "on":
                with profiling.recording():
                    rates[state].append(run_turn())
            else:
                rates[state].append(run_turn())
    return {k: {"runs": v, "median": statistics.median(v)}
            for k, v in rates.items()}


def rollout_turn_fn(chunks):
    cfg_json, tr = config("routing4_pyb"), traffic("rollout16384")
    b, chunk = int(tr["num_envs"]), int(tr["chunk"])
    cfg, task = port.build(cfg_json)
    reset_fn, step_fn = fast.make_fused_rollout(cfg, task, b, device=DEVICE)
    actions = float(tr["action_scale"]) * torch.randn(
        (chunk, b, cfg.num_drones, task.action_dim(cfg)),
        generator=torch.Generator(DEVICE).manual_seed(SEED), device=DEVICE)
    state = [reset_fn()[0]]

    def one_chunk():
        carry, rewards = state[0], []
        for t in range(chunk):
            carry, obs, rew, _, _ = step_fn(carry, actions[t])
            rewards.append(rew)
        torch.stack([torch.stack(rewards).sum(), obs.sum()]).tolist()
        state[0] = carry

    def run_turn():
        t0 = time.perf_counter()
        for _ in range(chunks):
            one_chunk()
        return chunks * chunk * b / (time.perf_counter() - t0)

    one_chunk()
    one_chunk()
    return run_turn


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--updates", type=int, default=12)
    p.add_argument("--chunks", type=int, default=24)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("span_cost: needs one CUDA card", file=sys.stderr)
        return 1
    print(json.dumps({"span_ns": span_ns()}), flush=True)
    fresh, one_update, new_gen, per_update = trainer()
    one_update(fresh(), new_gen())          # builds and warms up
    print(json.dumps({"update_bit_for_bit": update_bit_for_bit(
        fresh, one_update, new_gen)}), flush=True)
    ts, gen = fresh(), new_gen()

    def train_turn():
        nonlocal ts
        t0 = time.perf_counter()
        for _ in range(args.updates):
            ts, _ = one_update(ts, gen)
        return args.updates * per_update / (time.perf_counter() - t0)

    print(json.dumps({"train_rate": turns(train_turn, args.pairs)}),
          flush=True)
    print(json.dumps({"rollout_rate": turns(rollout_turn_fn(args.chunks),
                                            args.pairs)}), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip(), "torch": torch.__version__}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
