#!/usr/bin/env python3
"""Where `env_ctrl_step` and its plain version disagree on drones packed
close under downwash: whose fault is it, the kernel's or the inputs'?

    python3 scripts/downwash_witness.py [--other DIR] [--envs 4096]
        [--no-fma]

Needs one CUDA card.  For each input set below, it makes one batch of
inputs with `chip_smoke.pyb_case_states` (PYB_GND_DRAG_DW, the DSL-PID
preamble, obs12, the sphere and the box, drones `packed`; the last set is
that of `chip_smoke.py`'s geometry phase), and steps it through:

- `kernel`: this checkout's `env_ctrl_step` kernel;
- `kernel_other`: with `--other DIR`, the kernel of the checkout in DIR (for
  example the parent commit, unpacked with `git archive`), run in a
  process of its own that imports the package from DIR;
- `plain32` / `plain64`: the plain PyTorch version in float32 and float64.

With `--no-fma` both kernels are built with `-fmad=false`, so that the
compiler fuses no multiply-add (the plain version fuses none either).

For each pair of versions it counts the envs with some state or obs12 value
beyond `chip_smoke.py`'s tolerances for this case, and gives the largest
absolute difference, and the envs beyond by case share of
`pyb_case_states`; envs at a downwash tie (`chip_smoke.DW_TIE_MARGIN`) are
counted apart.  If the kernels disagree with `plain32` in the same envs
as `plain64` does, the inputs are chaotic there and neither kernel is at
fault.  Prints one JSON object.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SUBSTEPS, DT, CTRL_DT, SWEEPS = 8, 1 / 240, 1 / 30, 4
# label: (spacing [m], least height gap [m], drones deep in the sphere)
INPUT_SETS = {"packed_0.25m_2cm": (0.25, 0.02, True),
              "packed_0.45m_6cm": (0.45, 0.06, True),
              "packed_0.45m_6cm_not_deep": (0.45, 0.06, False)}


def load_chip_smoke():
    """This checkout's `chip_smoke.py` as a module (nothing runs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def dw_tie(cs, pos):
    """(n, 3, b) positions -> (b,) bool, as `chip_smoke.py` decides it:
    some pair of the env's drones within DW_TIE_MARGIN of one height."""
    tie = torch.zeros(pos.shape[2], dtype=torch.bool, device=pos.device)
    for i in range(pos.shape[0]):
        for j in range(i + 1, pos.shape[0]):
            tie |= (pos[i, 2] - pos[j, 2]).abs() < cs.DW_TIE_MARGIN
    return tie


def kernel_outputs(cs, root, inputs, no_fma):
    """Imports the package from `root` (first on the path) and runs its
    kernel on the arrays of `inputs`; returns the outputs as numpy arrays
    and the package's directory."""
    sys.path.insert(0, root)
    from gym_pybullet_drones_tpu_torch import _build, params as P
    if no_fma and "-fmad=false" not in _build.NVCC_FLAGS:
        # before the first launch builds; the flags name the libraries
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-fmad=false",)
    from gym_pybullet_drones_tpu_torch.ops import kernel_env
    from gym_pybullet_drones_tpu_torch.utils.enums import Physics
    dev = torch.device("cuda", 0)
    t = {k: torch.from_numpy(inputs[k]).to(dev)
         for k in ("state", "act", "pid", "last")}
    out = kernel_env.env_ctrl_step_rows(
        P.CF2X, P.CF2X, Physics.PYB_GND_DRAG_DW, int(inputs["n"]),
        N_SUBSTEPS, DT, CTRL_DT, (cs.SPHERE, cs.BOX), t["state"], t["act"],
        t["pid"], t["last"], True, SWEEPS)
    torch.cuda.synchronize()
    return {"state": out[0].cpu().numpy(), "obs12": out[3].cpu().numpy(),
            "package": os.path.dirname(kernel_env.__file__)}


def make_inputs(cs, rng, b, n, spacing, min_dz, deep):
    """Inputs of `chip_smoke.py`'s geometry case for n drones, as numpy,
    and the case shares of `pyb_case_states`."""
    from gym_pybullet_drones_tpu_torch import params as P
    st, cases = cs.pyb_case_states(rng, b, n, P.CF2X, dw=True, packed=True,
                                   spacing=spacing, min_dz=min_dz, deep=deep)
    rows = lambda x: np.ascontiguousarray(
        x.transpose(1, 2, 0).reshape(x.shape[1], b * n).astype(np.float32))
    tgt = np.zeros((n, 12, b))
    tgt[:, 0:3] = st[:, 0:3] + rng.normal(size=(n, 3, b)) * 0.3
    tgt[:, 5] = rng.normal(size=(n, b)) * 0.5
    tgt[:, 6:9] = rng.normal(size=(n, 3, b)) * 0.2
    pid = (rng.normal(size=(9, b * n)) * np.repeat(
        [0.05, 0.01, 0.1], 3)[:, None]).astype(np.float32)
    last = (P.CF2X.hover_rpm * (1 + 0.05 * rng.normal(size=(4, b * n)))
            ).astype(np.float32)
    return {"state": rows(st), "act": rows(tgt), "pid": pid, "last": last,
            "n": np.int64(n), "pos0": st[:, 0:3]}, cases


def plain_outputs(cs, inputs, dtype):
    """The plain version on the card in `dtype`, as float32 numpy."""
    from gym_pybullet_drones_tpu_torch import params as P
    from gym_pybullet_drones_tpu_torch.ops import kernel_env
    from gym_pybullet_drones_tpu_torch.utils.enums import Physics
    dev = torch.device("cuda", 0)
    t = {k: torch.from_numpy(inputs[k]).to(dev, dtype)
         for k in ("state", "act", "pid", "last")}
    out = kernel_env.env_ctrl_step_plain(
        P.CF2X, P.CF2X, Physics.PYB_GND_DRAG_DW, int(inputs["n"]),
        N_SUBSTEPS, DT, CTRL_DT, (cs.SPHERE, cs.BOX), t["state"], t["act"],
        t["pid"], t["last"], True, SWEEPS)
    return {"state": out[0].float().cpu().numpy(),
            "obs12": out[3].float().cpu().numpy()}


def compare(cs, got, ref, n, tied, cases):
    """Envs with a value of `got` beyond chip_smoke.py's tolerances for
    this case against `ref`, the largest absolute difference, and the envs
    beyond by case share (the envs past the named shares: `free`)."""
    wide = lambda tol: tuple(max(x, y) for x, y in zip(tol, cs.PID_STATE_TOL))
    vel, angv = wide(cs.PYB_VEL_TOL), wide(cs.PYB_ANGV_TOL)
    tols = {"state": cs.row_tols(16, [(0, 16, cs.PID_STATE_TOL),
                                      (7, 10, vel), (13, 16, angv)]),
            "obs12": cs.row_tols(12, [(0, 12, cs.PID_STATE_TOL),
                                      (6, 9, vel), (9, 12, angv)])}
    beyond = torch.zeros(len(tied), dtype=torch.bool, device="cuda")
    max_abs = 0.0
    for k, (atol, rtol) in tols.items():
        g = torch.from_numpy(got[k]).cuda()
        r = torch.from_numpy(ref[k]).cuda()
        err = (g - r).abs()
        bad = ~(err <= atol + rtol * r.abs())   # NaN counts as beyond
        beyond |= bad.any(dim=0).reshape(-1, n).any(dim=1)
        max_abs = max(max_abs, float(torch.nan_to_num(
            err, nan=float("inf")).max()))
    by_case = {k: int(beyond[sl].sum()) for k, sl in cases.items()}
    by_case["free"] = int(beyond.sum()) - sum(by_case.values())
    return {"envs_beyond": int((beyond & ~tied).sum()),
            "envs_beyond_at_a_tie": int((beyond & tied).sum()),
            "max_abs": max_abs,
            "by_case": {k: v for k, v in by_case.items() if v}}, beyond


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="a checkout whose kernel to run too")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-fma", action="store_true",
                    help="build both kernels with -fmad=false")
    ap.add_argument("--kernel-only", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)  # the --other process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("downwash_witness: needs one CUDA card", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    if args.kernel_only:
        src, dst = args.kernel_only
        np.savez(dst, **kernel_outputs(cs, args.other, dict(np.load(src)),
                                       args.no_fma))
        return 0
    sys.path.insert(0, ROOT)
    work = os.path.join(ROOT, "build", "downwash_witness")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    report = {"gpu": cs.gpu_line(), "envs": args.envs, "seed": args.seed,
              "no_fma": args.no_fma, "cases": []}
    for label, (spacing, min_dz, deep) in INPUT_SETS.items():
        for n in (4, 8):
            inputs, cases = make_inputs(cs, rng, args.envs, n, spacing,
                                        min_dz, deep)
            versions = {"kernel": kernel_outputs(cs, ROOT, inputs,
                                                 args.no_fma),
                        "plain32": plain_outputs(cs, inputs, torch.float32),
                        "plain64": plain_outputs(cs, inputs, torch.float64)}
            packages = {"kernel": versions["kernel"].pop("package")}
            if args.other:
                src = os.path.join(work, "inputs.npz")
                dst = os.path.join(work, "other.npz")
                np.savez(src, **inputs)
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--other", os.path.abspath(args.other),
                                "--kernel-only", src, dst]
                               + ["--no-fma"] * args.no_fma, check=True)
                versions["kernel_other"] = dict(np.load(dst))
                packages["kernel_other"] = str(
                    versions["kernel_other"].pop("package"))
            tied = dw_tie(cs, torch.from_numpy(inputs["pos0"]).cuda())
            case = {"inputs": label, "n": n, "packages": packages,
                    "envs_at_a_tie": int(tied.sum())}
            beyond = {}
            for a, b in (("kernel", "plain32"), ("kernel_other", "plain32"),
                         ("kernel", "kernel_other"), ("plain64", "plain32"),
                         ("kernel", "plain64"), ("kernel_other", "plain64")):
                if a in versions and b in versions:
                    case[f"{a}_vs_{b}"], beyond[(a, b)] = compare(
                        cs, versions[a], versions[b], n, tied, cases)
            # of the envs where the kernel is beyond plain32, how many are
            # beyond where plain64 is too
            both = beyond[("kernel", "plain32")] \
                & beyond[("plain64", "plain32")]
            case["kernel_beyond_plain32_where_plain64_is_too"] = int(
                both.sum())
            report["cases"].append(case)
            print(json.dumps(case), file=sys.stderr, flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
