#!/usr/bin/env python3
"""Launch geometry of the `render` kernel, and what FMA contraction would
buy it, measured.

    python3 scripts/render_launch_sweep.py [--threads 128 256]
        [--pixels 1 2 4 8] [--other LABEL=DIR ...] [--turns N] [--out DIR]

Needs one CUDA card and nvcc.  Builds `csrc/render.cu` from patched copies
under DIR, all at once with the package's own nvcc flags: once per
threads-a-block T and pixels-a-thread P (label `T<T>P<P>`: the two
`#define`s of `GPD_RENDER_THREADS` and `GPD_RENDER_PIXELS` replaced, the
rest as it stands), once as it stands but without `-fmad=false` (label
`fma`: the compiler free to contract products and sums into FMAs), and
with `--other` once more from the `csrc/render.cu` of another checkout in
DIR (e.g. the parent commit, from `git archive`) as it stands.

Every build is held against the plain version (`ops/render.py`) on the
card at each shape: rgba, depth and seg bit for bit, and, for any build
that is not, `ops/render_check.py`'s comparison (its max errors and tie
share, or the limit it broke).  Then, in turns (the order reversed every
other turn: parent, change, change, parent), it times every build's
launch on the same inputs under `chip_smoke.py`'s CUDA-graph harness
(rgba only, as on the observation path), beside the package's own wrapper
(`wrapper`: outputs from `torch.empty` at every call) and the launch floor
(`launch_floor`: a one-element in-place add), at 256, 512 and 4096
cameras of 64x48 over the landmark scene, one drone an env.  Prints one
JSON line per build (geometry, ptxas registers and spills), per check,
per shape (`ms` by build, one value per turn) and, where `cuobjdump`
exists, per build's SASS of the kernel (`sass_layout`: instruction
count; MUFU, FCHK, branch, call, barrier and reconvergence counts; the
barriers' places; each loop, one per backward branch, with its size and
counts), which it also writes under DIR; then the card's name and power
limit.  Exits 1 if a build made with `-fmad=false` is not bit for bit the
plain version.
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

import chip_smoke  # noqa: E402  (graph_ms, render_inputs, gpu_line)
from gym_pybullet_drones_tpu_torch import _build, params as P  # noqa: E402
from gym_pybullet_drones_tpu_torch.ops import kernel_render, render  # noqa: E402
from gym_pybullet_drones_tpu_torch.ops.render_check import compare_render  # noqa: E402

SRC = _build.KERNELS["render"][0]
NO_FMA = _build.EXTRA_FLAGS["render"]
SHAPES = (("hover256_rgb", 256), ("ppo_rgb512", 512), ("rgb4096", 4096))
WIDTH, HEIGHT = 64, 48
DEFINE = r"#define {} \d+\n"


def patched(text, threads, pixels):
    """render.cu's text with its geometry's two #defines replaced."""
    for name, value in (("GPD_RENDER_THREADS", threads),
                        ("GPD_RENDER_PIXELS", pixels)):
        text, n = re.subn(DEFINE.format(name), f"#define {name} {value}\n",
                          text)
        if n != 1:
            raise RuntimeError(f"{SRC}: `#define {name}` not found once")
    return text


def variant(out_dir, threads, pixels):
    """A copy of the package's render.cu under out_dir with its geometry
    patched; its path."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC_DIR, SRC)) as f:
        text = patched(f.read(), threads, pixels)
    path = os.path.join(out_dir, SRC)
    with open(path, "w") as f:
        f.write(text)
    return path


def build(threads, pixels, others, out_dir):
    """{label: (library path, ptxas figures, fmad=false?)}, every nvcc at
    once."""
    srcs = {f"T{t}P{p}": (variant(os.path.join(out_dir, f"T{t}P{p}"), t, p),
                          NO_FMA)
            for t in threads for p in pixels}
    srcs["fma"] = (os.path.join(_build.CSRC_DIR, SRC), ())
    for other in others:
        label, path = other.split("=", 1)
        srcs[label] = (os.path.join(path, "gym_pybullet_drones_tpu_torch",
                                    "csrc", SRC), NO_FMA)
    procs = []
    for label, (src, flags) in srcs.items():
        d = os.path.join(out_dir, label)
        os.makedirs(d, exist_ok=True)
        lib = os.path.join(d, "librender.so")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, src]
        procs.append((label, lib, flags, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    _build.load()       # the package's own build, for the wrapper
    libs = {}
    for label, lib, flags, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{out}")
        libs[label] = (lib, chip_smoke.ptxas_figures(out), bool(flags))
    return libs


def load(path):
    """(launcher, geometry function) of one build."""
    lib = ctypes.CDLL(path)
    lib.gpd_params_size.restype = ctypes.c_int
    if lib.gpd_params_size() != ctypes.sizeof(_build.RenderParams):
        raise RuntimeError(f"{path}: its parameter struct is not "
                           "_build.RenderParams")
    fn = lib.gpd_render
    fn.argtypes, fn.restype = _build._ARGTYPES["gpd_render"], ctypes.c_int
    geo = lib.gpd_render_geometry
    geo.argtypes = [ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    geo.restype = None
    return fn, geo


def geometry(geo, c):
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    geo(c, WIDTH * HEIGHT, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def launch(fn, pos, quat, rp, rgba, depth=None, seg=None):
    """One launch of a build's `gpd_render` into the given outputs."""
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(pos.data_ptr(), pos.stride(0), pos.stride(1), quat.data_ptr(),
             quat.stride(0), quat.stride(1), rgba.data_ptr(), rgba.stride(0),
             ptr(depth), ptr(seg), pos.shape[0], ctypes.byref(rp),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"render launch failed: CUDA error {err}")


def check(fn, pos, quat, rp, ref):
    """A build's (rgba, depth, seg) against the plain version's `ref`."""
    c, dev = pos.shape[0], pos.device
    got = (torch.empty((c, WIDTH * HEIGHT * 4), device=dev),
           torch.empty((c, HEIGHT, WIDTH), device=dev),
           torch.empty((c, HEIGHT, WIDTH), dtype=torch.int32, device=dev))
    launch(fn, pos, quat, rp, *got)
    torch.cuda.synchronize()
    rec = {"bitwise": all(torch.equal(g, r) for g, r in zip(got, ref))}
    try:
        cmp = compare_render("render", got, ref, pos,
                             render.camera_forward(quat), P.CF2X.l)
        rec.update((k, cmp[k]) for k in (
            "rgba_max_abs_err", "depth_max_abs_err", "seg_differ",
            "checker_ties", "tie_share"))
    except AssertionError as e:      # beyond ops/render_check.py's limits
        rec["beyond_limits"] = str(e)
    return rec


KINDS = ("MUFU", "FCHK", "BRA", "CALL", "BAR", "BSSY", "RET", "EXIT")


def sass_layout(sass):
    """The render kernel's instructions in `cuobjdump -sass` text: their
    count, their counts by kind (MUFU by function), the barriers' indices,
    and the loops, one per backward branch, each its [first, last]
    instruction index, size and counts by kind; None without the kernel."""
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if "render_kernel" not in part.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        ops = [op.split()[1] if op.startswith("@") else op.split()[0]
               for _, op in ins]

        def kinds(first, last):
            out = {}
            for o in ops[first:last + 1]:
                key = o if o.startswith("MUFU") else o.split(".")[0]
                if key.split(".")[0] in KINDS:
                    out[key] = out.get(key, 0) + 1
            return out

        index = {addr: i for i, (addr, _) in enumerate(ins)}
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr \
                    and int(m.group(1), 16) in index:
                j = index[int(m.group(1), 16)]
                loops.append({"span": [j, i], "size": i - j + 1,
                              "kinds": kinds(j, i)})
        return {"instructions": len(ins), "kinds": kinds(0, len(ins) - 1),
                "bars": [i for i, o in enumerate(ops) if o.startswith("BAR")],
                "loops": loops}
    return None


def sass_counts(path, out_dir):
    """`sass_layout` of one build's library, its SASS (`cuobjdump -sass`)
    written under out_dir; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], check=True,
                          capture_output=True, text=True).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "render.sass"), "w") as f:
        f.write(sass)
    return sass_layout(sass)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="*", default=[128, 256])
    ap.add_argument("--pixels", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--other", action="append", default=[],
                    help="LABEL=DIR: another checkout whose render.cu to time")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "render_launch_sweep"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("render_launch_sweep: needs one CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    libs = build(args.threads, args.pixels, args.other, args.out)
    scene = render.landmark_scene()
    rp = kernel_render.render_params(P.CF2X, scene, 1, WIDTH, HEIGHT)
    fns = {label: load(lib) for label, (lib, _, _) in libs.items()}
    for label, (lib, ptxas, no_fma) in libs.items():
        print(json.dumps({"build": label, "fmad_false": no_fma,
                          "geometry": {name: geometry(fns[label][1], c)
                                       for name, c in SHAPES},
                          "ptxas": ptxas}), flush=True)
    one = torch.zeros(1, device=dev)
    failed = []
    for name, c in SHAPES:
        pos, quat = chip_smoke.render_inputs(
            np.random.default_rng(chip_smoke.SEED + 5), c, 1, dev)
        ref = kernel_render.render_drones_plain(P.CF2X, scene, pos, quat, 1,
                                                WIDTH, HEIGHT)
        for label, (fn, _) in fns.items():
            rec = check(fn, pos, quat, rp, ref)
            if libs[label][2] and not rec["bitwise"]:
                failed.append((label, name))
            print(json.dumps({"check": label, "shape": name, **rec}),
                  flush=True)
        rgba = torch.empty((c, WIDTH * HEIGHT * 4), device=dev)
        runs = {label: (lambda fn=fn: launch(fn, pos, quat, rp, rgba))
                for label, (fn, _) in fns.items()}
        runs["wrapper"] = lambda: kernel_render.render_drones(
            P.CF2X, scene, pos, quat, 1, WIDTH, HEIGHT)
        runs["launch_floor"] = lambda: one.add_(1.0)
        labels = list(runs)
        ms = {label: [] for label in labels}
        for turn in range(args.turns):
            for label in (labels if turn % 2 == 0 else labels[::-1]):
                ms[label].append(chip_smoke.graph_ms(runs[label],
                                                     per_graph=20,
                                                     replays=10))
        print(json.dumps({"shape": name, "cameras": c, "ms": ms,
                          "median": {k: float(np.median(v))
                                     for k, v in ms.items()}}), flush=True)
    for label, (lib, _, _) in libs.items():
        print(json.dumps({"sass": label, "counts": sass_counts(
            lib, os.path.join(args.out, label))}), flush=True)
    print(chip_smoke.gpu_line(), flush=True)
    if failed:
        print(f"render_launch_sweep: not bit for bit: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
