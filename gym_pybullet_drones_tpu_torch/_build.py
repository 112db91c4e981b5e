"""Builds and loads the package's hand-written CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`; all sources are
compiled at once, one `nvcc` process each.  Nothing here runs at import
time: the first kernel launch calls `load()`.  Libraries go under `build/`
next to the package (or `$GPD_TORCH_BUILD_DIR`), named by a hash of every
file in `csrc/` and the compiler flags, so an edited source is rebuilt and
an unchanged one is reused.

A build failure is an exception.  There is no other way to run a kernel on
a CUDA tensor, and no fallback.

`StepParams` mirrors `GpdStepParams` in `csrc/drone_kernels.cuh` field by
field, `RenderParams` mirrors `GpdRenderParams` in `csrc/render.cu`; each
source exports `gpd_params_size`, and `load()` checks it against the
mirror of that kernel's struct (`PARAMS`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# No --use_fast_math: it swaps sinf/cosf/sqrtf and division for
# approximations, and the exponential-map quaternion update is sensitive.
# -Xptxas -v costs nothing and puts each kernel's registers, stack frame and
# spills into `build_log`.

MAX_DRONES = 8     # GPD_MAX_DRONES
MAX_OBSTACLES = 8  # GPD_MAX_OBSTACLES

# kernel name -> (source file, C entry point)
KERNELS = {
    "dyn_ctrl_step": ("dyn_ctrl_step.cu", "gpd_dyn_ctrl_step"),
    "pid_dyn_ctrl_step": ("pid_dyn_ctrl_step.cu", "gpd_pid_dyn_ctrl_step"),
    "fused_env_step": ("fused_env_step.cu", "gpd_fused_env_step"),
    "env_ctrl_step": ("env_ctrl_step.cu", "gpd_env_ctrl_step"),
    "render": ("render.cu", "gpd_render"),
}
# flags beyond NVCC_FLAGS, per kernel: the renderer is held against its
# plain version product for product, so nothing is contracted into an FMA
EXTRA_FLAGS = {"render": ("-fmad=false",)}

MAX_SPHERES = 8        # GPD_MAX_SPHERES
MAX_BOXES = 8          # GPD_MAX_BOXES
MAX_RENDER_DRONES = 8  # GPD_RENDER_MAX_DRONES


class DroneConsts(ctypes.Structure):
    """Mirror of `GpdDrone`."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "kf", "km_s", "k_arm", "inv_m", "gm", "jx", "jy", "jz",
        "inv_jx", "inv_jy", "inv_jz", "hover_rpm")] + [
        ("plus_mixer", ctypes.c_int)]


class PidConsts(ctypes.Structure):
    """Mirror of `GpdPid`: the controller's drone model."""

    _fields_ = [("kf4", ctypes.c_float), ("gravity", ctypes.c_float),
                ("plus_mixer", ctypes.c_int)]


class TorqueAxis(ctypes.Structure):
    """Mirror of `GpdTorqueAxis`: one body torque axis as paired factored
    rpm differences (`ops/rigid_body._prop_coef_pairs`) and leftovers."""

    _fields_ = [("n_pairs", ctypes.c_int), ("n_left", ctypes.c_int),
                ("pair_i", ctypes.c_int * 2), ("pair_j", ctypes.c_int * 2),
                ("left_i", ctypes.c_int * 4),
                ("pair_c", ctypes.c_float * 2), ("left_c", ctypes.c_float * 4)]


class PybConsts(ctypes.Structure):
    """Mirror of `GpdPyb`: the PYB-family physics of one configuration."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "enabled", "gnd", "drag", "dw", "sweeps", "n_obstacles")] + [
        ("tau_x", TorqueAxis), ("tau_y", TorqueAxis),
        ("prop_x", ctypes.c_float * 4), ("prop_y", ctypes.c_float * 4)] + [
        (name, ctypes.c_float) for name in (
            "m", "two_inv_m", "gnd_eff_coeff", "gnd_eff_h_clip",
            "prop_radius")] + [
        ("neg_drag_c", ctypes.c_float * 3)] + [
        (name, ctypes.c_float) for name in (
            "rpm_to_rad", "dw1", "dw2", "dw3", "lin_damp", "ang_damp",
            "erp_dt", "inv_dt", "mu", "slop", "rc", "z_lo", "z_hi",
            "min_d")] + [
        ("obs_kind", ctypes.c_int * MAX_OBSTACLES),
        ("obs", (ctypes.c_float * 9) * MAX_OBSTACLES)]


class StepParams(ctypes.Structure):
    """Mirror of `GpdStepParams`: every constant of one configuration."""

    _fields_ = [("drone", DroneConsts), ("pid", PidConsts),
                ("pyb", PybConsts)] + [
        (name, ctypes.c_int) for name in (
            "n_drones", "n_substeps", "act_dim", "buf_rows", "act_type",
            "task_id", "n_extra", "relative_actions", "shaped")] + [
        (name, ctypes.c_float) for name in (
            "dt", "half_dt", "ctrl_dt", "pyb_freq", "episode_len_sec",
            "box_xy", "box_z", "tilt", "speed_limit", "step_size",
            "action_scale", "arrival_tol", "collision_r2", "progress_gain",
            "arrival_hold")] + [
        ("init16", (ctypes.c_float * 16) * MAX_DRONES),
        ("target", (ctypes.c_float * 3) * MAX_DRONES),
    ]


class RenderParams(ctypes.Structure):
    """Mirror of `GpdRenderParams`: every constant of one render
    configuration (`ops/kernel_render.py` fills it)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "width", "height", "group", "n_spheres", "n_boxes")] + [
        (name, ctypes.c_float) for name in (
            "l", "tan_half", "far", "depth_scale", "drone_r",
            "drone_excl")] + [
        ("light", ctypes.c_float * 3), ("sky", ctypes.c_float * 3),
        ("ambient", ctypes.c_float), ("diffuse", ctypes.c_float),
        ("checker", ctypes.c_float * 2), ("drone_color", ctypes.c_float * 3),
        ("sphere", (ctypes.c_float * 4) * MAX_SPHERES),
        ("sphere_color", (ctypes.c_float * 3) * MAX_SPHERES),
        ("sphere_id", ctypes.c_int * MAX_SPHERES),
        ("box_center", (ctypes.c_float * 3) * MAX_BOXES),
        ("box_half", (ctypes.c_float * 3) * MAX_BOXES),
        ("box_color", (ctypes.c_float * 3) * MAX_BOXES),
        ("box_id", ctypes.c_int * MAX_BOXES),
    ]


# kernel name -> the ctypes mirror of its parameter struct
PARAMS = {name: StepParams for name in KERNELS}
PARAMS["render"] = RenderParams

_P = ctypes.c_void_p  # every pointer and the stream: never a bare int
_ARGTYPES = {
    # state, rpm, out, obs12 (may be NULL), B, ld, params, stream
    "gpd_dyn_ctrl_step": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(StepParams), _P],
    # state, pid, targets, out, pid out, rpm out, obs12 (may be NULL), B,
    # ld, params, stream
    "gpd_pid_dyn_ctrl_step": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, ctypes.POINTER(StepParams), _P],
    # carry, action rows, carry out, outs, B, ld, params, stream
    "gpd_fused_env_step": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(StepParams), _P],
    # state, actions, pid (may be NULL), last rpm (may be NULL), out, rpm
    # out, pid out (may be NULL), obs12 (may be NULL), envs, ld, params,
    # stream
    "gpd_env_ctrl_step": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                          ctypes.c_int, ctypes.POINTER(StepParams), _P],
    # pos, its two strides, quat, its two strides, rgba, ld, depth (may be
    # NULL), seg (may be NULL), cameras, params, stream
    "gpd_render": [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                   ctypes.c_int, _P, ctypes.c_int, _P, _P, ctypes.c_int,
                   ctypes.POINTER(RenderParams), _P],
}

_loaded: dict | None = None
_geometry: dict = {}                # kernel name -> its C geometry function
# kernel name -> its C occupancy function, for the sources that export one
# (`<entry>_occupancy`)
_occupancy: dict = {}
build_seconds: float | None = None  # wall time `load()` spent in `build()`
# wall time of the first `load()` as a whole: the build, every library's
# load and its parameter struct's check
load_seconds: float | None = None
build_log: dict = {}                # kernel name -> nvcc output, when built


def find_nvcc() -> str:
    """Path of `nvcc`, from PATH, $CUDA_HOME or the toolkit's usual place."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> str:
    return os.environ.get(
        "GPD_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(PACKAGE_DIR), "build", "kernels"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode()
                       + repr(sorted(EXTRA_FLAGS.items())).encode())
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile whatever is not built yet; return {kernel name: library path}.

    The compilers' output is kept in `build_log`.
    """
    tag = _source_hash()
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths, procs = {}, []
    for name, (src, _) in KERNELS.items():
        lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
        paths[name] = lib
        if os.path.isfile(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()), "-o",
               tmp, os.path.join(CSRC_DIR, src)]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name} ({' '.join(cmd)}):\n{out}")
        build_log[name] = out
        os.replace(tmp, lib)  # atomic: concurrent processes may build too
    return paths


def load() -> dict:
    """Build if needed, load, and return {kernel name: bound C function}."""
    global _loaded, build_seconds, load_seconds
    if _loaded is not None:
        return _loaded
    t0 = time.perf_counter()
    paths = build()
    build_seconds = time.perf_counter() - t0
    fns = {}
    for name, (_, entry) in KERNELS.items():
        lib = ctypes.CDLL(paths[name])
        lib.gpd_params_size.restype = ctypes.c_int
        mirror = PARAMS[name]
        if lib.gpd_params_size() != ctypes.sizeof(mirror):
            raise RuntimeError(
                f"{name}: its parameter struct is {lib.gpd_params_size()} "
                f"bytes, its ctypes mirror {mirror.__name__} "
                f"{ctypes.sizeof(mirror)}")
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
        geo = getattr(lib, entry + "_geometry")
        geo.argtypes = [ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int)]
        geo.restype = None
        _geometry[name] = geo
        if hasattr(lib, entry + "_occupancy"):
            occ = getattr(lib, entry + "_occupancy")
            occ.argtypes = [ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int)]
            occ.restype = ctypes.c_int
            _occupancy[name] = occ
    _loaded = fns
    load_seconds = time.perf_counter() - t0
    return fns


def launch_geometry(name: str, b: int, n_drones: int = 1) -> tuple:
    """(blocks, threads per block) of the launch kernel `name` makes for
    its C argument B = `b` and `n_drones`, from the function of the same
    source that its launcher calls (`<entry>_geometry`).  For `render`,
    `b` is the number of cameras and `n_drones` the pixels of one."""
    load()
    blocks, threads = ctypes.c_int(), ctypes.c_int()
    _geometry[name](b, n_drones, ctypes.byref(blocks), ctypes.byref(threads))
    return blocks.value, threads.value


def resident_blocks(name: str, n_drones: int, pyb: bool) -> int:
    """Blocks of kernel `name`'s launch over envs of `n_drones` drones
    (`pyb`: the PYB family, whose pose buffers take shared memory) that
    one SM of the current device holds at once: the CUDA runtime's
    occupancy for the kernel as built, its block and the launcher's own
    shared memory, from the function of the same source
    (`<entry>_occupancy`)."""
    load()
    blocks = ctypes.c_int()
    err = _occupancy[name](n_drones, int(pyb), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {err}")
    return blocks.value
