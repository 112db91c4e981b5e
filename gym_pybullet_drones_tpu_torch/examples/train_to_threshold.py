"""Seeded training runs to the reference's solved thresholds, on the card.

    python -m gym_pybullet_drones_tpu_torch.examples.train_to_threshold \\
        --seed 0 --anneal --max_updates 400 --out curve.json
    ... --multiagent --num_envs 128 --hidden 128 --gamma 0.995 --anneal
    ... --rgb --num_envs 512 --rollout_steps 32 --epochs 4 --lr 1e-4 --anneal
    ... --routing --num_envs 128 --rollout_steps 64 --epochs 10 --lr 3e-4 \
        --anneal --gamma 0.99 --log_std_init -1 --hidden 128
    ... --sharded 8 --backend gloo --num_envs 128 --anneal

Counterpart of the JAX package's `scripts/train_to_threshold.py` for Hover
(ONE_D_RPM, target 474.15), MultiHover (2 drones, target 949.5), both on
PYB physics, RGB Hover (ONE_D_RPM, target 474.15, DYN physics, each
drone's camera image as its observation, the NatureCNN policy) and the
routing fleet (`--routing`: `make_routing_config(num_drones=3,
spacing=0.4)`, PYB physics, PID waypoint actions): the same flags, the
same configurations (240 Hz under 30 Hz control, 4 minibatches), an
evaluation after every update, and the same fields in the JSON curve it
writes.  The Hover thresholds are the reference's early-stop values (its
examples/learn.py:78-83), evaluated by `evaluate(episodic=True)`; the
routing target is an all-arrivals rate of 0.9 over 64 deterministic
episodes of 16 s (`rl.ppo.make_arrival_rate`; the reference defines no
routing threshold).  `platform` is "gpu" and `device` the card's name and
power limit as nvidia-smi prints them ("cpu" with `--device cpu`).

`--sharded N` trains data-parallel over N ranks, each its own process
(spawned; `parallel.launch.run_ranks`): rank r steps env columns
[r*E/N, (r+1)*E/N) of the global batch, the gradient of every optimizer
step is all-reduced (`make_train(..., mesh=)`), each rank evaluates its
columns and the returns are gathered, so that every rank stops at the
same update; the routing evaluation runs on rank 0, which broadcasts the
rate.  `--backend nccl` (the default) takes one card a rank and refuses
fewer cards than ranks; `--backend gloo` lets the ranks share a card.
Rank 0 writes the JSON, with `sharded_devices` (N) and `backend`.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

from gym_pybullet_drones_tpu_torch import _build, params as P
from gym_pybullet_drones_tpu_torch.envs import (
    AviaryConfig, HoverTask, MultiHoverTask, make_routing_config)
from gym_pybullet_drones_tpu_torch.parallel import make_sharded_update
from gym_pybullet_drones_tpu_torch.parallel.distributed import (
    check_backend)
from gym_pybullet_drones_tpu_torch.parallel.launch import run_ranks
from gym_pybullet_drones_tpu_torch.rl import (
    PPOConfig, make_arrival_rate, make_train)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)


def device_name(device: torch.device) -> str:
    """The card's name and power limit, or the CPU."""
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"], check=True,
        capture_output=True, text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--multiagent", action="store_true")
    ap.add_argument("--routing", action="store_true")
    ap.add_argument("--rgb", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--max_updates", type=int, default=400)
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=64,
                    help="MLP tower width (two layers)")
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--log_std_init", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--rollout_steps", type=int, default=64)
    ap.add_argument("--anneal", action="store_true",
                    help="linear LR anneal over max_updates")
    ap.add_argument("--epochs", type=int, default=10,
                    help="PPO update epochs")
    ap.add_argument("--out", default=None,
                    help="output path (default: "
                         "artifacts/torch_<task>_seed<seed>.json)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="train over N ranks, the env batch split")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="--sharded's process group (gloo: ranks may "
                         "share a card)")
    args = ap.parse_args(argv)
    if not args.sharded:
        return train(args, resolve_device(args.device))
    check_backend(args.backend, args.sharded)
    if args.device is None or torch.device(args.device).type == "cuda":
        _build.build()        # once here, not in every rank
    return run_ranks(_rank, args.sharded, args.backend, args=(args,),
                     device=args.device)[0]


def _rank(mesh, args):
    return train(args, mesh.device, mesh)


def train(args, device: torch.device, mesh=None) -> int:
    """The run on `device`, or this rank's part of it under `mesh`; 0 if
    it reached its target.  Only rank 0 writes and prints."""
    lead = mesh is None or mesh.rank == 0
    if args.routing:
        cfg, task = make_routing_config(num_drones=3, spacing=0.4)
        name, target, physics = "routing", 0.9, cfg.physics
    elif args.rgb:
        name, target, physics = "hover_rgb", 474.15, Physics.DYN
        cfg = AviaryConfig(drone=P.CF2X, num_drones=1, physics=physics,
                           pyb_freq=240, ctrl_freq=30)
        task = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB)
    else:
        num_drones = 2 if args.multiagent else 1
        target = 949.5 if args.multiagent else 474.15
        name = "multihover" if args.multiagent else "hover"
        physics = Physics.PYB
        cfg = AviaryConfig(drone=P.CF2X, num_drones=num_drones,
                           physics=physics, pyb_freq=240, ctrl_freq=30)
        task = (MultiHoverTask if args.multiagent else HoverTask)(
            act=ActionType.ONE_D_RPM)
    ppo = PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                    num_minibatches=4, update_epochs=args.epochs,
                    total_timesteps=(args.max_updates * args.num_envs
                                     * args.rollout_steps),
                    anneal_lr=args.anneal, gamma=args.gamma, lr=args.lr,
                    log_std_init=args.log_std_init,
                    hidden=(args.hidden, args.hidden))
    init, update, evaluate, _ = make_train(cfg, task, ppo, device=device,
                                           mesh=mesh)
    ts = init(torch.Generator(device).manual_seed(args.seed))
    if mesh is not None:
        update = make_sharded_update(update, mesh)
    if args.routing:
        # success metric: the share of 64 deterministic episodes in which
        # EVERY drone reaches its destination within the 16 s episode;
        # under a mesh rank 0 evaluates and broadcasts the rate
        arrival_rate = make_arrival_rate(
            cfg, task, 64, int(task.episode_len_sec * cfg.ctrl_freq),
            device) if lead else None

        def eval_fn(net):
            rate = arrival_rate(net)[0] if lead \
                else torch.zeros((), device=device)
            if mesh is not None:
                mesh.broadcast(rate)
            return float(rate)
    else:
        # reference episode accounting (QUIRKS.md #11): the default step
        # count episode_len_sec * ctrl_freq + 2, stopped at the first
        # terminated/truncated
        eval_fn = lambda net: float(evaluate(net, episodic=True).mean())

    curve = []
    start = time.time()
    reached_at = None
    for u in range(args.max_updates):
        ts, metrics = update(ts)
        mean_ret = eval_fn(ts.network)
        curve.append({
            "update": u,
            "env_steps": (u + 1) * ppo.batch_size,
            "eval_return": mean_ret,
            "train_reward": float(metrics["mean_reward"]),
            "wall_s": round(time.time() - start, 1),
        })
        if lead and (u % 5 == 0 or mean_ret >= target):
            print(f"[{name} seed {args.seed}] update {u} "
                  f"steps={(u + 1) * ppo.batch_size} eval={mean_ret:.2f} "
                  f"({time.time() - start:.0f}s)", flush=True)
        if mean_ret >= target:
            reached_at = u
            break

    out = {
        "task": name,
        "metric": "all_arrivals_rate" if args.routing else "eval_return",
        "action_type": "pid_waypoint" if args.routing else "one_d_rpm",
        "obs_type": task.obs.value,
        "physics": physics.value,
        "seed": args.seed,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": device_name(device),
        "torch": torch.__version__,
        "target_reward": target,
        "reference_source":
            ("gym_pybullet_drones/envs/BaseAviary.py:1105-1147 "
             "(routing machinery; threshold is ours — the reference "
             "defines none)") if args.routing else
            "gym_pybullet_drones/examples/learn.py:78-83",
        "env_path": update.env_path,
        "sharded_devices": None if mesh is None else mesh.size,
        "backend": None if mesh is None else mesh.backend,
        "reached": reached_at is not None,
        "reached_at_update": reached_at,
        "reached_at_env_steps":
            None if reached_at is None else (reached_at + 1) * ppo.batch_size,
        "best_eval_return": max(c["eval_return"] for c in curve),
        "total_wall_s": round(time.time() - start, 1),
        "ppo": {"num_envs": ppo.num_envs, "rollout_steps": ppo.rollout_steps,
                "num_minibatches": ppo.num_minibatches,
                "update_epochs": ppo.update_epochs, "lr": ppo.lr,
                "anneal_lr": ppo.anneal_lr, "gamma": ppo.gamma,
                "log_std_init": ppo.log_std_init,
                "hidden": list(ppo.hidden)},
        "curve": curve,
    }
    if lead:
        path = args.out or os.path.join(
            os.path.dirname(__file__), "..", "..", "artifacts",
            f"torch_{name}_seed{args.seed}.json")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[RESULT] {name}: reached={out['reached']} "
              f"at update {reached_at} -> {path}", flush=True)
    return 0 if out["reached"] else 1


if __name__ == "__main__":
    sys.exit(main())
