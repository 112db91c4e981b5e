#!/usr/bin/env python3
"""Launch geometry and unroll depth of `dyn_ctrl_step` and
`pid_dyn_ctrl_step`, measured.

    python3 scripts/dyn_launch_sweep.py [--threads 32 64 128] [--unroll 2 7]
        [--other LABEL=DIR ...] [--turns N] [--out DIR]

Needs one CUDA card and nvcc.  Builds both sources once per thread count
(label `T<T>`) and once per unroll depth of the substep loop (label `U<U>`:
U substeps an iteration, then the rest one at a time; 7 unrolls the 7
substeps before the peeled last one of a control step of 8), and once with
the loop's count fixed at compile time (label `N8`: 7 substeps in a rolled
loop, then the last, right for these 8-substep inputs only), each from a
copy of the package's `csrc/` under DIR with that one change made to
`drone_kernels.cuh` (`GPD_DYN_THREADS`, the loop of `gpd_dyn_substeps`),
the rest as it stands; and with `--other` once more from the `csrc/` of
another checkout in DIR (e.g. the parent commit, from `git archive`) as it
stands; every build at once, with the package's own nvcc flags.  Then, in
turns, it times every build's launch on the same inputs under
`chip_smoke.py`'s CUDA-graph harness, beside the package's own wrapper
(`wrapper`: this checkout's build, its outputs from `torch.empty` at every
call) and the launch floor (`launch_floor`: a one-element in-place add):
`dyn_ctrl_step` at hover4096 (B = 4096), the same with its first four
columns at rest (`hover4096_rest4`: zero rates and equal rpm, as in
`chip_smoke.py`'s timed input), multihover2x8192 (B = 16384) and one warp
(B = 32), `pid_dyn_ctrl_step` at routing4x4096 (B = 16384) and one warp,
all at 8 substeps with the obs12 block.  Prints one JSON line per kernel
and shape (`ms` by build, one value per turn), then the card's name and
power limit.

It also writes the SASS of every build (`cuobjdump -sass`) under DIR and
prints, for each build of both kernels, its instruction count and where
the reciprocal / square-root unit instructions (MUFU) and the calls into
the slow paths of division and square root sit in its instruction stream.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (graph_ms, rand_state_rows, gpu_line)
from gym_pybullet_drones_tpu_torch import _build, params as P  # noqa: E402
from gym_pybullet_drones_tpu_torch.ops import kernel_dyn, kernel_pid  # noqa: E402

DT, CTRL_DT, SUB = 1 / 240, 1 / 30, 8
NAMES = ("dyn_ctrl_step", "pid_dyn_ctrl_step")


THREADS_LINE = "#define GPD_DYN_THREADS 64\n"
SUBSTEP = "gpd_dyn_substep(c, dt, half_dt, s, thrust, xt, yt, zt, r);"
LOOP = ("    for (int i = 1; i < n_substeps; ++i)\n"
        "        " + SUBSTEP + "\n")


def unrolled_loop(u):
    """The substep loop of `gpd_dyn_substeps`, u substeps an iteration."""
    body = "".join("        " + SUBSTEP + "\n" for _ in range(u))
    return ("    int i = 1;\n"
            f"    for (; i + {u} <= n_substeps; i += {u}) {{\n" + body
            + "    }\n    for (; i < n_substeps; ++i)\n        "
            + SUBSTEP + "\n")


def variant(out_dir, old, new):
    """A copy of the package's csrc/ under out_dir with `old` replaced by
    `new` in drone_kernels.cuh; its path."""
    csrc = os.path.join(out_dir, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    path = os.path.join(csrc, "drone_kernels.cuh")
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise RuntimeError(f"drone_kernels.cuh: {old!r} not found once")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return csrc


def build(threads, unroll, others, out_dir):
    """{build label: {kernel name: library path}}, every nvcc at once."""
    builds = {f"T{t}": variant(os.path.join(out_dir, f"T{t}"), THREADS_LINE,
                               f"#define GPD_DYN_THREADS {t}\n")
              for t in threads}
    builds.update({f"U{u}": variant(os.path.join(out_dir, f"U{u}"), LOOP,
                                    unrolled_loop(u)) for u in unroll})
    fixed = "#pragma unroll 1\n" + LOOP.replace("i < n_substeps", f"i < {SUB}")
    builds["N8"] = variant(os.path.join(out_dir, "N8"), LOOP, fixed)
    for other in others:
        label, path = other.split("=", 1)
        builds[label] = os.path.join(path, "gym_pybullet_drones_tpu_torch",
                                     "csrc")
    procs, libs = [], {}
    for label, csrc in builds.items():
        d = os.path.join(out_dir, label)
        os.makedirs(d, exist_ok=True)
        libs[label] = {}
        for name in NAMES:
            lib = os.path.join(d, f"lib{name}.so")
            libs[label][name] = lib
            cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                   os.path.join(csrc, _build.KERNELS[name][0])]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
    return libs


def load(path, name):
    """(launcher, geometry function) of one built source."""
    lib = ctypes.CDLL(path)
    entry = _build.KERNELS[name][1]
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = _build._ARGTYPES[entry], ctypes.c_int
    geo = getattr(lib, entry + "_geometry")
    geo.argtypes = [ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    geo.restype = None
    return fn, geo


def geometry(geo, b):
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    geo(b, 1, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def inputs(name, b, dev, rest=0):
    """Fixed inputs of width b, the same for every build; the first `rest`
    columns of `dyn_ctrl_step`'s at rest (zero rates, equal rpm), as in the
    keep-branch columns of `chip_smoke.py`'s checks."""
    rng = np.random.default_rng(chip_smoke.SEED)
    s = torch.from_numpy(chip_smoke.rand_state_rows(rng, b)).to(dev)
    if name == "dyn_ctrl_step":
        rpm = torch.from_numpy((P.CF2X.hover_rpm * (
            1 + 0.02 * rng.normal(size=(4, b)))).astype(np.float32)).to(dev)
        s[10:13, :rest] = 0.0
        rpm[:, :rest] = P.CF2X.hover_rpm
        return s, rpm
    pid = torch.from_numpy((rng.normal(size=(9, b)) * np.repeat(
        [0.05, 0.01, 0.1], 3)[:, None]).astype(np.float32)).to(dev)
    tgt = np.zeros((12, b), np.float32)
    tgt[0:3] = rng.normal(size=(3, b)) * 0.5 + [[0.0], [0.0], [1.0]]
    tgt[5] = rng.normal(size=b) * 0.5
    tgt[6:9] = rng.normal(size=(3, b)) * 0.2
    return s, pid, torch.from_numpy(tgt).to(dev)


def launcher(name, fn, ins):
    """A function that launches `fn` once on `ins`, into fixed outputs."""
    b, dev = ins[0].shape[1], ins[0].device
    rows = lambda k: torch.empty((k, b), device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    if name == "dyn_ctrl_step":
        sp = kernel_dyn._step_params(P.CF2X, SUB, DT)
        outs = [rows(16), rows(12)]
    else:
        sp = kernel_pid._step_params(P.CF2X, P.CF2X, SUB, DT, CTRL_DT)
        outs = [rows(k) for k in (16, 9, 4, 12)]
    keep = (*ins, *outs)        # alive as long as the launcher is
    return lambda: fn(*(t.data_ptr() for t in keep), b, b, ctypes.byref(sp),
                      stream())


def wrapper(name, ins):
    """The package's own wrapper on `ins`: outputs from `torch.empty`."""
    if name == "dyn_ctrl_step":
        return lambda: kernel_dyn.dyn_ctrl_step_rows(P.CF2X, *ins, SUB, DT,
                                                     True)
    return lambda: kernel_pid.pid_dyn_ctrl_step_rows(
        P.CF2X, P.CF2X, *ins, SUB, DT, CTRL_DT, True)


def sass_layout(path, name, out_dir):
    """Per kernel function of `name`'s build: instruction count and the
    indices of its MUFU instructions and slow-path calls, from cuobjdump's
    SASS."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
        f.write(sass)
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = part.split("\n", 1)[0].strip()
        if "_kernel" not in fname:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
        marks = [(i, op.split()[0] if not op.startswith("@") else
                  op.split()[1]) for i, (_, op) in enumerate(ins)
                 if "MUFU" in op or "CALL" in op]
        out[fname] = {
            "instructions": len(ins),
            "marks": [f"{i}:{m}" for i, m in marks]}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="*", default=[32, 64, 128])
    ap.add_argument("--unroll", type=int, nargs="*", default=[2, 7])
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=DIR: another checkout whose csrc/ to time")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "dyn_launch_sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dyn_launch_sweep: needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build(args.threads, args.unroll, args.other, args.out)
    one = torch.zeros(1, device=dev)
    floor = lambda: one.add_(1.0)
    shapes = (("dyn_ctrl_step", "hover4096", 4096, 0),
              ("dyn_ctrl_step", "hover4096_rest4", 4096, 4),
              ("dyn_ctrl_step", "multihover2x8192", 16384, 0),
              ("dyn_ctrl_step", "one_warp", 32, 0),
              ("pid_dyn_ctrl_step", "routing4x4096", 16384, 0),
              ("pid_dyn_ctrl_step", "one_warp", 32, 0))
    for name, shape, b, rest in shapes:
        ins = inputs(name, b, dev, rest)
        runs, geo = {}, {}
        for label in libs:
            fn, g = load(libs[label][name], name)
            geo[label] = geometry(g, b)
            runs[label] = launcher(name, fn, ins)
        runs["wrapper"] = wrapper(name, ins)
        geo["wrapper"] = _build.launch_geometry(name, b)
        runs["launch_floor"] = floor
        ms = {label: [] for label in runs}
        for _ in range(args.turns):
            for label, run in runs.items():
                ms[label].append(chip_smoke.graph_ms(run))
        print(json.dumps({"kernel": name, "shape": shape, "B": b,
                          "geometry": geo, "ms": ms}), flush=True)
    libs["default"] = _build.build()     # this checkout's default build
    for label, paths in libs.items():
        for name in NAMES:
            print(json.dumps({"sass": name, "build": label,
                              "layout": sass_layout(
                                  paths[name], name,
                                  os.path.join(args.out, label))}),
                  flush=True)
    print(chip_smoke.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
