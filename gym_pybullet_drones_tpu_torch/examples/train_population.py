"""Multi-seed training to the reference's solved threshold, on the card.

    python -m gym_pybullet_drones_tpu_torch.examples.train_population \\
        --task multihover --seed 0 --out curve.json

Counterpart of the JAX package's `scripts/train_population.py`: a
population of K seeds trains at once in one trainer (`rl/population.py`:
one fused env launch a control step for all K members, every policy layer
one batched product over them), each seed's deterministic policy is
evaluated after every `--eval_every` updates (`pop_evaluate(episodic=
True)`, the reference episode of 242 control steps), and the JSON records
every seed's curve and its first crossing of the threshold (949.5 for
MultiHover, 474.15 for Hover: the reference's examples/learn.py:78-83).
The same flags and defaults (MultiHover on PYB physics, 240 Hz under 30
Hz control, ONE_D_RPM, K = 8, 128 envs a seed x 64 steps, 4 minibatches,
10 epochs, lr 3e-4 annealed over `--max_updates`, gamma 0.995, 128 x 128),
with `--device` (default: the CUDA card) in place of `--platform`.  The
JSON has the JAX script's fields, `device` is the card's name and power
limit as nvidia-smi prints them, and it adds each seed's best return and
crossing time, the seconds an update and the fused kernel's launches.

Population seed s: the members' weights, noise and permutations all come
from `torch.Generator(device).manual_seed(s)`.  The exit code is 0 when at
least max(2, 2K // 3) seeds crossed, as the JAX script's.
"""
import argparse
import json
import os
import sys
import time

import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import (
    AviaryConfig, HoverTask, MultiHoverTask)
from gym_pybullet_drones_tpu_torch.examples.train_to_threshold import (
    device_name)
from gym_pybullet_drones_tpu_torch.ops import kernel_fused
from gym_pybullet_drones_tpu_torch.rl import (
    PPOConfig, make_train_population)
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device
from gym_pybullet_drones_tpu_torch.utils.enums import ActionType, Physics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="multihover",
                    choices=["multihover", "hover"])
    ap.add_argument("--num_policies", type=int, default=8)
    ap.add_argument("--max_updates", type=int, default=1400)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--num_envs", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--gamma", type=float, default=0.995)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ent_coef", type=float, default=0.0)
    ap.add_argument("--log_std_init", type=float, default=0.0)
    ap.add_argument("--rollout_steps", type=int, default=64)
    ap.add_argument("--sb3_minibatching", action="store_true",
                    help="SB3's exact flattened-(T*E) minibatch shuffle "
                         "instead of time-axis subsets (rl/ppo.py)")
    ap.add_argument("--no_anneal", action="store_true",
                    help="constant lr (SB3's default schedule)")
    ap.add_argument("--num_minibatches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0,
                    help="population seed: the generator of every member's "
                         "weights and draws")
    ap.add_argument("--eval_every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--env_path", default=None,
                    choices=[None, "fused", "batched"])
    ap.add_argument("--out", default=None,
                    help="output path (default: artifacts/torch_<task>_"
                         "population<K>_seed<seed>.json)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    multi = args.task == "multihover"
    target = 949.5 if multi else 474.15
    cfg = AviaryConfig(drone=P.CF2X, num_drones=2 if multi else 1,
                       physics=Physics.PYB, pyb_freq=240, ctrl_freq=30)
    task = (MultiHoverTask if multi else HoverTask)(act=ActionType.ONE_D_RPM)
    ppo = PPOConfig(num_envs=args.num_envs, rollout_steps=args.rollout_steps,
                    num_minibatches=args.num_minibatches,
                    update_epochs=args.epochs,
                    total_timesteps=(args.max_updates * args.num_envs
                                     * args.rollout_steps),
                    anneal_lr=not args.no_anneal, lr=args.lr,
                    gamma=args.gamma, ent_coef=args.ent_coef,
                    log_std_init=args.log_std_init,
                    sb3_minibatching=args.sb3_minibatching,
                    hidden=(args.hidden, args.hidden))
    K = args.num_policies
    pinit, pupd, peval, _ = make_train_population(
        cfg, task, ppo, K, device=device, env_path=args.env_path)
    card = device_name(device)
    print(f"[population] task={args.task} K={K} env_path={pupd.env_path} "
          f"device={card}", flush=True)

    ts = pinit(torch.Generator(device).manual_seed(args.seed))
    kernel_fused.launches = 0
    curve = []
    reached_at, reached_wall = [None] * K, [None] * K
    best = [float("-inf")] * K
    start = time.time()
    train_s = 0.0
    prev_crossed = 0
    for u in range(args.max_updates):
        t0 = time.time()
        ts, metrics = pupd(ts)
        if u % args.eval_every and u != args.max_updates - 1:
            train_s += time.time() - t0
            continue
        float(metrics["mean_reward"].sum())          # the update has ended
        train_s += time.time() - t0
        per_seed = peval(ts.network, episodic=True).mean(dim=1).tolist()
        wall = time.time() - start
        for i, r in enumerate(per_seed):
            best[i] = max(best[i], r)
            if reached_at[i] is None and r >= target:
                reached_at[i], reached_wall[i] = u, round(wall, 1)
        curve.append({"update": u,
                      "env_steps_per_seed": (u + 1) * ppo.batch_size,
                      "eval_return": [round(r, 2) for r in per_seed],
                      "wall_s": round(wall, 1)})
        crossed = sum(r is not None for r in reached_at)
        if u % 50 == 0 or crossed != prev_crossed:
            print(f"[{args.task} pop] update {u} crossed={crossed}/{K} "
                  f"best={max(per_seed):.1f} "
                  f"mean={sum(per_seed) / K:.1f} ({wall:.0f}s)", flush=True)
        prev_crossed = crossed
        if crossed == K:
            break

    updates = curve[-1]["update"] + 1
    crossed = sum(r is not None for r in reached_at)
    out = {
        "task": args.task,
        "metric": "eval_return",
        "action_type": "one_d_rpm",
        "num_policies": K,
        "population_seed": args.seed,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "device": card,
        "torch": torch.__version__,
        "env_path": pupd.env_path,
        "target_reward": target,
        "reference_source": "gym_pybullet_drones/examples/learn.py:78-83",
        "seeds_crossed": crossed,
        "crossed_of_first3": sum(r is not None for r in reached_at[:3]),
        "reached_at_update": reached_at,
        "reached_at_env_steps": [
            None if r is None else (r + 1) * ppo.batch_size
            for r in reached_at],
        "reached_at_wall_s": reached_wall,
        "best_eval_return": [round(b, 2) for b in best],
        "updates_run": updates,
        "total_wall_s": round(time.time() - start, 1),
        "train_seconds_per_update": train_s / updates,
        "fused_env_step_launches": kernel_fused.launches,
        "ppo": {"num_envs": ppo.num_envs, "rollout_steps": ppo.rollout_steps,
                "num_minibatches": ppo.num_minibatches,
                "update_epochs": ppo.update_epochs, "lr": ppo.lr,
                "anneal_lr": ppo.anneal_lr, "gamma": ppo.gamma,
                "ent_coef": ppo.ent_coef,
                "log_std_init": ppo.log_std_init,
                "sb3_minibatching": ppo.sb3_minibatching,
                "hidden": list(ppo.hidden),
                "max_updates": args.max_updates},
        "note": ("all seeds train in one trainer (rl/population.py): one "
                 "fused env launch a control step for all of them; anneal "
                 "horizon = max_updates; wall_s counts the evaluations, "
                 "train_seconds_per_update does not"),
        "curve": curve,
    }
    path = args.out or os.path.join(
        os.path.dirname(__file__), "..", "..", "artifacts",
        f"torch_{args.task}_population{K}_seed{args.seed}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[RESULT] {args.task} population: {crossed}/{K} seeds crossed "
          f"{target} (first3: {out['crossed_of_first3']}/3) -> {path}",
          flush=True)
    return 0 if crossed >= max(2, (2 * K) // 3) else 1


if __name__ == "__main__":
    sys.exit(main())
