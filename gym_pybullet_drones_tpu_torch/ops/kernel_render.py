"""CUDA kernel: the ray-tracing camera of every drone, one launch a frame.

The JAX package renders its RGB observations with one fused XLA program
(`gym_pybullet_drones_tpu/ops/render.py`); it has no Pallas kernel for it.
Eager PyTorch would run the same function as some 300 elementwise launches
a frame, so on the card it is one hand-written kernel,
`csrc/render.cu`, and `ops/render.py` is its plain version.

Cameras sit at the drones of a flat (env x drone) batch: camera c at
position `pos[c]` with attitude `quat[c]`, seeing the scene and the
`group` drones of its env (rows `(c // group) * group ...` of `pos`).
A block takes 1024 consecutive pixels of one camera, 4 a thread; it puts
what the camera's rays share (the basis, each sphere's and box's terms
that depend on the eye only, the pixel offsets of each row and column)
into shared memory once.  The kernel writes rgba as one float4 per pixel
straight into the (C, H*W*4) observation rows, in HWC order (the JAX
layout, and the CNN's flattened input); depth and segmentation only when
asked.

What bounds it on an H100: its float32 work, some 420 operations a pixel
against 67 TFLOP/s, not the 16 bytes of rgba a pixel writes.  It is built
without FMA contraction, to be bit for bit `ops/render.py`, so it issues
each product and sum as its own instruction; its design issues each of
them once per camera, ray or winning hit where the plain version repeats
them per pixel or per primitive (the source's note, `PERF.md`).

`render_drones_plain` is the same function in plain PyTorch; the wrapper
uses it only for tensors that lie on the CPU.  On a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from gym_pybullet_drones_tpu_torch import _build
from gym_pybullet_drones_tpu_torch.ops import render
from gym_pybullet_drones_tpu_torch.utils import graphs
from gym_pybullet_drones_tpu_torch.utils.profiling import span

launches = 0  # kernel launches made by `render_drones` (CUDA only)


@functools.lru_cache(maxsize=32)
def render_params(params, scene: render.Scene, group: int, width: int,
                  height: int) -> _build.RenderParams:
    """The kernel's parameter struct; every constant is rounded once to
    float32 from the double the plain version rounds."""
    ns, nb = len(scene.sphere_radius), len(scene.box_id)
    if ns > _build.MAX_SPHERES or nb > _build.MAX_BOXES:
        raise ValueError(f"at most {_build.MAX_SPHERES} spheres and "
                         f"{_build.MAX_BOXES} boxes, got {ns} and {nb}")
    rp = _build.RenderParams()
    rp.width, rp.height, rp.group = width, height, group
    rp.n_spheres, rp.n_boxes = ns, nb
    near = params.l
    rp.l = near
    rp.tan_half = math.tan(math.radians(render.FOV_DEG) / 2)
    rp.far, rp.depth_scale = render.FAR, render.FAR / (render.FAR - near)
    rp.drone_r, rp.drone_excl = 2 * near, 3 * near
    rp.light[:] = render.unit_light().tolist()
    rp.sky[:] = render.SKY
    rp.ambient, rp.diffuse = render.AMBIENT, render.DIFFUSE
    rp.checker[:] = render.CHECKER
    rp.drone_color[:] = render.DRONE_COLOR
    for i in range(ns):
        rp.sphere[i][:] = tuple(scene.sphere_center[i]) \
            + (scene.sphere_radius[i],)
        rp.sphere_color[i][:] = scene.sphere_color[i]
        rp.sphere_id[i] = scene.sphere_id[i]
    for i in range(nb):
        rp.box_center[i][:] = scene.box_center[i]
        rp.box_half[i][:] = scene.box_half[i]
        rp.box_color[i][:] = scene.box_color[i]
        rp.box_id[i] = scene.box_id[i]
    return rp


def render_drones_plain(params, scene: render.Scene, pos: torch.Tensor,
                        quat: torch.Tensor, group: int, width: int = 64,
                        height: int = 48):
    """Plain PyTorch version of the kernel: (rgba (C, H*W*4), depth (C, H,
    W), seg (C, H, W)), on whatever device the inputs lie."""
    c = pos.shape[0]
    b = c // group
    fwd = render.camera_forward(quat)
    rgba, depth, seg = render.render_along(
        params, scene, pos.reshape(b, group, 3), fwd.reshape(b, group, 3),
        pos.reshape(b, 1, group, 3), width, height)
    return (rgba.reshape(c, height * width * 4),
            depth.reshape(c, height, width), seg.reshape(c, height, width))


def render_drones(params, scene: render.Scene, pos: torch.Tensor,
                  quat: torch.Tensor, group: int, width: int = 64,
                  height: int = 48, depth_seg: bool = False):
    """The camera of each of C drones: `pos` (C, 3), `quat` (C, 4) xyzw,
    any strides; C a multiple of `group`, the drones per env.

    Returns rgba (C, H*W*4) in [0, 255], HWC order, or (rgba, depth (C, H,
    W), seg (C, H, W) int32) with `depth_seg`.  A CUDA tensor launches the
    kernel on the current stream (float32 only; no synchronisation;
    outputs from `torch.empty`); a CPU tensor runs `render_drones_plain`
    in its own dtype.  Anything the kernel does not take raises.  The
    CPU path, or the launch, is the span `kernel.render`
    (`utils.profiling.span`; attribute `cameras`, C); the launch goes
    through `utils.graphs.launch`.
    """
    for name, t, k in (("pos", pos, 3), ("quat", quat, 4)):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"{name} must be a floating-point tensor")
        if t.dim() != 2 or t.shape[1] != k:
            raise ValueError(f"{name} must be (C, {k}), got {tuple(t.shape)}")
    c = pos.shape[0]
    if quat.shape[0] != c or quat.device != pos.device \
            or quat.dtype != pos.dtype:
        raise ValueError("pos and quat must hold the same cameras on the "
                         "same device, in one dtype")
    if group < 1 or c % group:
        raise ValueError(f"{c} cameras do not split into envs of {group}")
    if group > _build.MAX_RENDER_DRONES:
        raise ValueError(f"at most {_build.MAX_RENDER_DRONES} drones an env")
    if pos.device.type == "cpu":
        with span("kernel.render", cameras=c):
            out = render_drones_plain(params, scene, pos, quat, group, width,
                                      height)
        return out if depth_seg else out[0]
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    if pos.dtype != torch.float32:
        raise TypeError(f"the render kernel takes float32, got {pos.dtype}")
    fn = _build.load()["render"]
    npix = width * height
    rgba = torch.empty((c, npix * 4), dtype=torch.float32, device=pos.device)
    depth = seg = None
    if depth_seg:
        depth = torch.empty((c, height, width), dtype=torch.float32,
                            device=pos.device)
        seg = torch.empty((c, height, width), dtype=torch.int32,
                          device=pos.device)
    rp = render_params(params, scene, group, width, height)

    def go():
        global launches
        with span("kernel.render", cameras=c), torch.cuda.device(pos.device):
            err = fn(pos.data_ptr(), pos.stride(0), pos.stride(1),
                     quat.data_ptr(), quat.stride(0), quat.stride(1),
                     rgba.data_ptr(), rgba.stride(0),
                     depth.data_ptr() if depth_seg else None,
                     seg.data_ptr() if depth_seg else None, c,
                     ctypes.byref(rp),
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"render launch failed: CUDA error {err}")
        launches += 1
    graphs.launch(go)
    return (rgba, depth, seg) if depth_seg else rgba
