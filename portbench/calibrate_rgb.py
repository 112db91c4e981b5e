"""The readings that the limits of the pixel training cell are set from.

    python3 -m portbench.calibrate_rgb --workload hover_rgb.ppo512 \
        --seeds 1,2,... --fault-seeds 7,8,9 [--out FILE]

One process, one card.  For each of `--seeds`, a sound run of the program
as the cell runs it (set-up's checked updates and a window of one kept
update, `drivers/train_rgb.py`) and its numbers: the lower readings.  For
each of `--fault-seeds`, the control and each fault planted in the
program's own timed path, through the same comparison: the upper
readings.

- `tf32` (the control): TF32 inside the program's convolutions and
  matrix products, forward and backward (the configuration states IEEE
  float32): the scope that the CNN and the minibatch step take for their
  convolutions sets cuDNN's TF32, and matrix products allow TF32 around
  the whole update.  A card only.
- `half_batch`: half of each minibatch left out of the loss.
- `unchanged`: every update leaves the policy's weights as it found them.
- `stale`: the observations one control step stale (each step hands the
  policy the image of the step before, as if the render were skipped).
- `altered`: one env's image altered where the env step produces it (its
  first value by a tenth).

`FAULTS` maps each name to a context manager that plants it; the CPU
tests (`tests/test_portbench_rgb.py`) plant them the same way.  Each
reading prints as one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def tf32():
    import torch
    from gym_pybullet_drones_tpu_torch.models import cnn
    from gym_pybullet_drones_tpu_torch.rl import ppo

    @contextlib.contextmanager
    def tf32_convs():
        conv = torch.backends.cudnn.conv
        prev = conv.fp32_precision
        conv.fp32_precision = "tf32"
        try:
            yield
        finally:
            conv.fp32_precision = prev

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with _patched(cnn, "ieee_fp32_convs", tf32_convs), \
                _patched(ppo, "ieee_fp32_convs", tf32_convs):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def half_batch():
    from gym_pybullet_drones_tpu_torch.rl import ppo

    def half(net, batch, advantages, returns, cfg, mesh=None):
        m = advantages.shape[1] // 2
        cut = type(batch)(*(x[:, :m] for x in batch))
        return real(net, cut, advantages[:, :m], returns[:, :m], cfg, mesh)
    with _patched(ppo, "ppo_loss", half) as real:
        yield


@contextlib.contextmanager
def unchanged():
    import torch
    from gym_pybullet_drones_tpu_torch.rl import ppo

    def make(*args, **kwargs):
        init, update, evaluate, net = real(*args, **kwargs)

        def frozen(ts, draws=None, after_rollout=None):
            keep = [p.detach().clone() for p in ts.network.parameters()]
            ts, metrics = update(ts, draws, after_rollout)
            with torch.no_grad():
                for p, k in zip(ts.network.parameters(), keep):
                    p.copy_(k)
            return ts, metrics
        frozen.env_path = update.env_path
        return init, frozen, evaluate, net
    with _patched(ppo, "make_train", make) as real:
        yield


def _broken_step(fault):
    """A context that wraps the trainer's batched env step (`rl/ppo.py`'s
    `make_batched_step`) to break the observations it returns."""
    @contextlib.contextmanager
    def plant():
        from gym_pybullet_drones_tpu_torch.rl import ppo

        def make(*args, **kwargs):
            reset_fn, step_fn = real(*args, **kwargs)
            last = []

            def step(state, action):
                state, obs, rew, term, trunc = step_fn(state, action)
                if fault == "stale":
                    new = obs
                    obs = last[0] if last else obs
                    last[:] = [new]
                else:
                    obs = obs.clone()
                    obs[0, 0] += 0.1 * (1.0 + obs[0, 0].abs())
                return state, obs, rew, term, trunc
            step.reset_noise = step_fn.reset_noise
            step.use_reset_noise = step_fn.use_reset_noise
            return reset_fn, step
        with _patched(ppo, "make_batched_step", make) as real:
            yield
    return plant


FAULTS = {"tf32": tf32, "half_batch": half_batch, "unchanged": unchanged,
          "stale": _broken_step("stale"), "altered": _broken_step("altered")}


def reading(cell, seed: int, device, fault=None, look=None) -> dict:
    """The numbers of one short run (no window beyond the kept update),
    with `fault` planted in the program's timed path.  `look`, a dict,
    gets each checked update's loss gap (`loss_gaps`: the three of
    set-up, then the window update's)."""
    from portbench.drivers import train_rgb
    with FAULTS[fault]() if fault else contextlib.nullcontext():
        out = train_rgb.train_loop(cell, seed, 0.0, False, device,
                                   time.time())
    return train_rgb.verify(cell, seed, out["check"], device, look)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate_rgb")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default=",".join(FAULTS))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    ints = lambda text: [int(x) for x in text.split(",") if x]

    from portbench import cell as cells
    cell = cells.load(args.workload)
    jobs = [(s, None) for s in ints(args.seeds)] + [
        (s, f) for f in args.faults.split(",") if f
        for s in ints(args.fault_seeds)]
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(open(args.out, "a")) if args.out \
            else None
        for seed, fault in jobs:
            look = {}
            numbers = reading(cell, seed, "cuda:0", fault, look)
            rec = {"workload": args.workload, "kind": fault or "sound",
                   "seed": seed, **numbers, **look}
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
