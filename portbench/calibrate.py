"""The readings that the limits of `correct` are set from, for one cell.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

One process, one card (a sharded cell: its ranks, spawned once).  For
each of `--seeds`, a sound run of the program as the cell runs it (a
short window) and its numbers: the lower readings.  For each of
`--control-seeds`, the control and the faults a cell of its kind can
have, through the same comparison: the upper readings.

- Rollout cells: the control is the plain reference computed in
  bfloat16, the precision below the configuration's float32, put in the
  program's place over the free-running steps from the reset; a step
  that returns its carry unchanged; an observation altered where it is
  produced (one env's first obs row by a tenth).
- Training cells: the control is the program with TF32 products
  switched on inside its calls (the configuration states float32 with
  TF32 off), beside the program's own bfloat16 policy
  (`PPOConfig.compute_dtype`); half of each minibatch left out, planted
  in the reference put in the program's place; for a sharded cell, the
  exchange between the ranks left out (the reference on rank 0's envs
  alone).  A state left unchanged reads 1 by `change_gap`'s measure and
  needs no run.

Each reading prints as one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _seeds(text):
    return [int(x) for x in text.split(",") if x]


def rollout_readings(cell, seeds, control_seeds, device, emit):
    import torch

    from portbench.drivers import rollout
    from portbench.reference import ref_env

    for seed in seeds:
        out = rollout.run(cell, seed, 0.5, False, device,
                          time.perf_counter())
        emit({"kind": "sound", "seed": seed, **out["numbers"]})
    tr = cell.traffic
    b, chunk = int(tr["num_envs"]), int(tr["chunk"])
    env = ref_env.make(cell.config)
    ro = env.n * env.obs_rows_per
    for seed in control_seeds:
        gen = torch.Generator(device).manual_seed(seed)
        actions = float(tr["action_scale"]) * torch.randn(
            (chunk, b, env.n, env.act_dim), generator=gen, device=device)
        for fault in ("bfloat16", "unchanged", "altered"):
            dt = torch.bfloat16 if fault == "bfloat16" else torch.float32
            with torch.no_grad():
                carry, obs_rows = env.reset(b, device, dt)
                start = obs_rows.float().t()
                free = []
                for t in range(int(tr["free_steps"])):
                    new, outs = env.step(carry, rollout._rows(actions[t],
                                                              dt))
                    if fault == "unchanged":
                        new = carry
                        outs = torch.cat([env.obs_of(carry), outs[ro:]])
                    outs = outs.float().clone()
                    if fault == "altered":
                        outs[0, 0] += 0.1 * (1.0 + outs[0, 0].abs())
                    carry = new
                    free.append((new.float(), outs[:ro].t(), outs[ro],
                                 outs[ro + 1] > 0.5, outs[ro + 2] > 0.5))
            numbers = rollout.verify(cell.config, b, actions, start, free,
                                     [], device)
            emit({"kind": fault, "seed": seed, **numbers})


def worst_leaf(prog: dict, ref: dict) -> str:
    """The tensor that sets a leaf gap (`check.leaf_gaps`)."""
    from portbench import check
    gaps = check.leaf_gap_map(prog, ref)
    return max(gaps, key=gaps.get)


def train_readings(cell, seeds, control_seeds, device, emit):
    """The numbers of sound and control runs (the program's bfloat16
    policy, and TF32 products inside its calls), each with the look
    beside it: every update's loss gap, the tensors that set the leaf
    gaps, and (one rank) how many of the check updates' (env, step) done
    flags the program and the reference disagree on, and the first such
    step.  Then the faults, planted in the reference put in the program's
    place: half of each minibatch left out (the first updates, and the
    window update from a control run's state), and for a sharded cell the
    exchange between the ranks left out."""
    import torch

    from portbench import check
    from portbench.drivers import train

    ppo = cell.config["ppo"]
    hidden = len(cell.config["policy"]["hidden"])
    ranks = int(cell.traffic.get("ranks", 1))
    steps = int(cell.traffic["check_updates"]) \
        * int(cell.traffic["rollout_steps"])
    jobs = [(s, None) for s in seeds] + [
        (s, p) for s in control_seeds for p in ("bfloat16", "tf32")]
    flags = []
    if ranks == 1:
        # record the program's done flags at each step (the look only;
        # `portbench.run` never wraps the program)
        from gym_pybullet_drones_tpu_torch.rl import ppo as port_ppo
        real = port_ppo.make_fused_rollout

        def recording(*args, **kwargs):
            reset_fn, step_fn = real(*args, **kwargs)

            def step(carry, action):
                out = step_fn(carry, action)
                if len(flags[-1]) < steps:
                    flags[-1].append(out[3] | out[4])
                return out
            return reset_fn, step
        port_ppo.make_fused_rollout = recording
        progs = []
        try:
            for s, precision in jobs:
                flags.append([])
                out = train.train_loop(None, cell, s, 0.0, False, device,
                                       0.0, precision)
                progs.append(train.merged_check([out]))
        finally:
            port_ppo.make_fused_rollout = real
    else:
        from gym_pybullet_drones_tpu_torch.parallel import launch
        per_rank = launch.run_ranks(calib_rank, ranks, "nccl",
                                    args=(cell, jobs), timeout_s=3000)
        progs = [train.merged_check([r[k] for r in per_rank])
                 for k in range(len(jobs))]
    states = {}
    for k, ((seed, precision), prog) in enumerate(zip(jobs, progs)):
        ref = train.reference_updates(cell, seed, device)
        p = train.as_tensors(prog)
        ref_win = train.reference_window(cell, p["window"], device)
        if precision == "tf32":
            states[seed] = p["window"]
        rec = {"kind": "sound" if precision is None else precision,
               "seed": seed,
               **check.train_numbers(p, ref, ppo, ref_win, hidden, device),
               "loss_gaps": check.loss_gaps(p, ref, ppo)
               + check.loss_gaps({"metrics": [p["window"]["metrics"]]},
                                 {"metrics": [ref_win["metrics"]]}, ppo),
               "grad_leaf": worst_leaf(p["mu1"], ref["mu1"]),
               "change_leaf": worst_leaf(p["change"], ref["change"]),
               "policy_calls": len(p["calls"])}
        if flags:
            differ = torch.stack(flags[k]).float().cpu() \
                != torch.stack(ref["dones"]).cpu()
            at = differ.any(dim=1).nonzero()
            rec["flag_mismatches"] = int(differ.sum())
            rec["first_mismatch_step"] = int(at[0]) if len(at) else None
        emit(rec)
    for seed in control_seeds:
        ref = train.reference_updates(cell, seed, device)
        ref_win = train.reference_window(cell, states[seed], device)
        faults = {"half_batch": dict(drop_half=True)}
        if ranks > 1:
            faults["no_exchange"] = dict(shard=ranks)
        for name, kw in faults.items():
            bad = train.reference_updates(cell, seed, device, **kw)
            against = None
            if name == "half_batch":
                bad["window"] = train.reference_window(
                    cell, states[seed], device, drop_half=True)
                against = ref_win
            emit({"kind": name, "seed": seed,
                  **check.train_numbers(bad, ref, ppo, against)})


def calib_rank(mesh, cell, jobs):
    """One rank's sound and control runs of a sharded cell, every seed in
    one spawn."""
    from portbench.drivers import train
    return [train.train_loop(mesh, cell, s, 0.0, False, None, 0.0,
                             precision) for s, precision in jobs]


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from portbench import cell as cells
    cell = cells.load(args.workload)
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        rec = {"workload": args.workload, **rec}
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    device = "cuda:0"
    kind = cell.traffic["driver"]
    try:
        if kind == "rollout":
            rollout_readings(cell, args.seeds, args.control_seeds, device,
                             emit)
        else:
            train_readings(cell, args.seeds, args.control_seeds, device,
                           emit)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
