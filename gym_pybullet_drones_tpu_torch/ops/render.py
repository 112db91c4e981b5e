"""Batched analytic ray-tracing camera: RGB / depth / segmentation.

Own copy of the JAX package's `ops/render.py`, in plain PyTorch.  The scene
is a small set of analytic primitives (ground plane, landmark boxes and
spheres, drone bodies) intersected in closed form, every pixel of every
camera in parallel.

Camera parity with the reference (BaseAviary._getDroneImages:565-617): eye
at drone pos + [0, 0, L], looking along the body +x axis, up [0, 0, 1],
vertical FOV 60 deg, aspect 1.0, near L, far 1000, resolution 64x48.  Depth
is an OpenGL-style normalized depth buffer like PyBullet's; segmentation is
an int32 object id (-1 background, 0 plane, 1.. scene objects, 100+
drones).

This is the plain version of the render kernel (`ops/kernel_render.py`,
`csrc/render.cu`): the CPU runs it, and the card's checks hold the kernel
against it.  Every vector sum is written out in the kernel's order (no
`linalg.norm`, no `cross`), so that a build without FMA contraction gives
the same floats.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

FOV_DEG = 60.0
FAR = 1000.0       # near comes from params.l
BIG = 1e9

# TinyRenderer-style fragment shading (the renderer behind the reference's
# p.getCameraImage, BaseAviary.py:606-613):
#   rgb = base_color * (AMBIENT + DIFFUSE * max(0, N . L))
# with PyBullet's TinyRendererVisualShapeConverter defaults
# lightAmbientCoeff=0.6 / lightDiffuseCoeff=0.35; the light direction is
# one pinned constant (PyBullet's default is scene-scaled), the same in
# both packages.
AMBIENT = 0.6
DIFFUSE = 0.35
LIGHT_DIR = (0.4, 0.3, 0.85)
SKY = (0.7, 0.85, 1.0)
CHECKER = (0.75, 0.55)     # plane greys where floor(x) + floor(y) is odd / even
DRONE_COLOR = (0.35, 0.35, 0.4)
DRONE_ID = 100             # drone m of an env has seg id DRONE_ID + m
IMAGE_SHAPE = (48, 64, 4)  # (H, W, C) of a camera image (reference IMG_RES)


class Scene(NamedTuple):
    """Static primitive scene, as plain Python tuples (hashable, like
    `DroneParams`): each field holds one entry per object.  `render`
    converts them to the camera's dtype and device at use, the kernel's
    wrapper into its parameter struct."""

    sphere_center: tuple   # ((x, y, z), ...)
    sphere_radius: tuple   # (r, ...)
    sphere_color: tuple    # ((r, g, b), ...)
    sphere_id: tuple       # (id, ...)
    box_center: tuple
    box_half: tuple
    box_color: tuple
    box_id: tuple


def landmark_scene() -> Scene:
    """The 4-landmark RGB-observation scene (reference BaseRLAviary.py:
    99-128: block @ [1, 0, .1], small cube @ [0, 1, .1], duck @ [-1, 0, .1],
    teddy @ [0, -1, .1], modelled as coloured boxes and spheres).  The base
    colours stand in for pybullet_data's materials, as in the JAX
    package."""
    return Scene(
        sphere_center=((-1.0, 0.0, 0.1), (0.0, -1.0, 0.1)),
        sphere_radius=(0.08, 0.1),
        sphere_color=((0.95, 0.8, 0.1), (0.6, 0.4, 0.2)),
        sphere_id=(3, 4),
        box_center=((1.0, 0.0, 0.1), (0.0, 1.0, 0.05)),
        box_half=((0.05, 0.05, 0.1), (0.025, 0.025, 0.05)),
        box_color=((0.8, 0.1, 0.1), (0.1, 0.3, 0.85)),
        box_id=(1, 2),
    )


def empty_scene() -> Scene:
    return Scene((), (), (), (), (), (), (), ())


def unit_light(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """LIGHT_DIR normalised in `dtype`, as the JAX package computes it."""
    light = torch.tensor(LIGHT_DIR, dtype=dtype, device=device)
    x, y, z = light
    return light / torch.sqrt(x * x + y * y + z * z)


def camera_forward(quat: torch.Tensor) -> torch.Tensor:
    """The view direction (..., 3) of cameras with attitude `quat` (...,
    4), xyzw: the first column of the normalised quaternion's rotation
    (`quat.quat_to_mat(quat)[..., :, 0]`), with its norm written out as
    the kernel computes it."""
    x, y, z, w = (quat[..., k] for k in range(4))
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                        2 * (x * z - w * y)], dim=-1)


def render(params, scene: Scene, cam_pos, cam_rot, drone_pos=None,
           width: int = 64, height: int = 48):
    """Render the view of cameras at `cam_pos` (..., 3) with rotations
    `cam_rot` (..., 3, 3); broadcasts over the leading batch dims and
    keeps their dtype and device.  Only the rotation's first column, the
    view direction, is read (`render_along`)."""
    return render_along(params, scene, cam_pos, cam_rot[..., :, 0],
                        drone_pos, width, height)


def render_along(params, scene: Scene, cam_pos, forward, drone_pos=None,
                 width: int = 64, height: int = 48):
    """`render` of cameras at `cam_pos` (..., 3) looking along `forward`
    (..., 3), a unit vector.

    drone_pos: optional (..., M, 3) drone positions rendered as spheres of
    radius 2L, broadcast against the cameras' batch dims; a drone within 3L
    of a camera is not drawn for it (the eye sits inside its own body).
    Returns (rgba (..., H, W, 4) float in [0, 255] with alpha 255, depth
    (..., H, W) buffer values, seg (..., H, W) int32).

    Per-pixel state is kept pixel-major, one (..., H*W) tensor per
    component, and the closest hit is a running minimum: the first
    primitive wins ties (strict <), in the order landmark spheres, drone
    spheres, boxes, plane.
    """
    dtype, device = cam_pos.dtype, cam_pos.device
    near = params.l
    batch = cam_pos.shape[:-1]
    npix = height * width
    f32 = lambda x: torch.tensor(x, dtype=dtype, device=device)

    def a1(x):
        """(...,) per camera -> (..., 1) for pixel broadcasting."""
        return x[..., None]

    eye = cam_pos + f32([0.0, 0.0, params.l])
    ox, oy, oz = a1(eye[..., 0]), a1(eye[..., 1]), a1(eye[..., 2])

    # camera basis: lookAt along body +x, world up (0, 0, 1); the cross
    # products written out, with the up vector's components
    f0, f1, f2 = (forward[..., k] for k in range(3))
    u0, u1, u2 = 0.0, 0.0, 1.0
    r0, r1, r2 = f1 * u2 - f2 * u1, f2 * u0 - f0 * u2, f0 * u1 - f1 * u0
    rn = torch.clamp(torch.sqrt(r0 * r0 + r1 * r1 + r2 * r2), min=1e-6)
    r0, r1, r2 = r0 / rn, r1 / rn, r2 / rn
    c0, c1, c2 = r1 * f2 - r2 * f1, r2 * f0 - r0 * f2, r0 * f1 - r1 * f0

    # the image-plane offsets of the pixel centres; the divisors are
    # tensors: torch on CUDA multiplies by the reciprocal of a Python-number
    # divisor, which is not the division the JAX package and the kernel
    # round
    tan_half = math.tan(math.radians(FOV_DEG) / 2)
    ar = lambda n: torch.arange(n, dtype=dtype, device=device)
    xs = (2 * (ar(width) + 0.5) / f32(float(width)) - 1) * tan_half
    ys = (1 - 2 * (ar(height) + 0.5) / f32(float(height))) * tan_half
    px = xs.repeat(height)                                 # (P,) row-major
    py = ys.repeat_interleave(width)

    # ray directions, one (..., P) tensor per component
    dx = a1(f0) + px * a1(r0) + py * a1(c0)
    dy = a1(f1) + px * a1(r1) + py * a1(c1)
    dz = a1(f2) + px * a1(r2) + py * a1(c2)
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz)
    dx, dy, dz = dx * inv_len, dy * inv_len, dz * inv_len

    shape = batch + (npix,)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    best = {"t": torch.full(shape, BIG, dtype=dtype, device=device),
            "nx": zero, "ny": zero, "nz": zero,
            "cr": zero, "cg": zero, "cb": zero,
            "id": torch.full(shape, -1, dtype=torch.int32, device=device)}

    def consider(t, nx, ny, nz, col, oid):
        m = t < best["t"]
        for k, v in (("t", t), ("nx", nx), ("ny", ny), ("nz", nz),
                     ("cr", col[0]), ("cg", col[1]), ("cb", col[2]),
                     ("id", oid)):
            best[k] = torch.where(m, v, best[k])

    def sphere(cx, cy, cz, r, col, oid):
        """cx/cy/cz/r broadcastable against (..., P)."""
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        disc = b * b - c2
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > 1e-4, t0, t1)
        t = torch.where((disc > 0) & (t > 1e-4), t, BIG)
        hx = ox + t * dx - cx
        hy = oy + t * dy - cy
        hz = oz + t * dz - cz
        inv_n = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz),
                                  min=1e-9)
        consider(t, hx * inv_n, hy * inv_n, hz * inv_n, col, oid)

    sc, sr = f32(scene.sphere_center), f32(scene.sphere_radius)
    for i in range(len(scene.sphere_radius)):
        sphere(sc[i, 0], sc[i, 1], sc[i, 2], sr[i],
               f32(scene.sphere_color[i]), scene.sphere_id[i])

    if drone_pos is not None:
        drone_col = f32(DRONE_COLOR)
        for m in range(drone_pos.shape[-2]):
            dpx, dpy, dpz = (drone_pos[..., m, k] for k in range(3))
            ex, ey, ez = (dpx - cam_pos[..., 0], dpy - cam_pos[..., 1],
                          dpz - cam_pos[..., 2])
            dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
            r = torch.where(dist < 3 * params.l, f32(0.0), f32(2 * params.l))
            sphere(a1(dpx), a1(dpy), a1(dpz), a1(r), drone_col,
                   DRONE_ID + m)

    bc, bh = f32(scene.box_center), f32(scene.box_half)
    for i in range(len(scene.box_id)):
        # slab method, one axis at a time
        tmin_ax, tmax_ax = [], []
        for k, (dk, ok) in enumerate(((dx, ox), (dy, oy), (dz, oz))):
            inv = 1.0 / torch.where(torch.abs(dk) > 1e-9, dk,
                                    torch.where(dk >= 0, 1e-9, -1e-9))
            lo = (bc[i, k] - bh[i, k] - ok) * inv
            hi = (bc[i, k] + bh[i, k] - ok) * inv
            tmin_ax.append(torch.minimum(lo, hi))
            tmax_ax.append(torch.maximum(lo, hi))
        tx, ty, tz = tmin_ax
        tmin = torch.maximum(torch.maximum(tx, ty), tz)
        tmax = torch.minimum(torch.minimum(tmax_ax[0], tmax_ax[1]),
                             tmax_ax[2])
        hit = tmax > torch.clamp(tmin, min=1e-4)
        t = torch.where(hit, torch.where(tmin > 1e-4, tmin, tmax), BIG)
        # normal: the axis of entry (first maximum, like argmax); sign(0)
        # is 0
        is_x = (tx >= ty) & (tx >= tz)
        is_y = (~is_x) & (ty >= tz)
        nx = torch.where(is_x, -torch.sign(dx), 0.0)
        ny = torch.where(is_y, -torch.sign(dy), 0.0)
        nz = torch.where(is_x | is_y, 0.0, -torch.sign(dz))
        consider(t, nx, ny, nz, f32(scene.box_color[i]), scene.box_id[i])

    # ground plane z = 0, a checkerboard; `remainder` is the floored modulo
    # (-1 % 2 == 1), as jnp's `%`
    t_p = torch.where(torch.abs(dz) > 1e-6, -oz / dz, BIG)
    t_p = torch.where(t_p > 1e-4, t_p, BIG)
    hpx, hpy = ox + t_p * dx, oy + t_p * dy
    checker = torch.remainder(torch.floor(hpx) + torch.floor(hpy), 2)
    pc = torch.where(checker > 0.5, f32(CHECKER[0]), f32(CHECKER[1]))
    consider(t_p, zero, zero, torch.ones_like(zero), (pc, pc, pc), 0)

    t_best = best["t"]
    hit_mask = t_best < FAR
    seg = torch.where(hit_mask, best["id"], -1)

    # ambient + diffuse shading, sky where nothing is hit
    light = unit_light(dtype, device)
    lam = torch.clamp(best["nx"] * light[0] + best["ny"] * light[1]
                      + best["nz"] * light[2], min=0.0)
    shade = AMBIENT + DIFFUSE * lam
    sky = f32(SKY)
    chans = [torch.clamp(torch.where(hit_mask, shade * best[c], sky[k])
                         * 255.0, 0, 255)
             for k, c in enumerate(("cr", "cg", "cb"))]

    # OpenGL-style depth buffer value (what p.getCameraImage returns)
    z = torch.clamp(t_best, near, FAR)
    depth = (FAR / (FAR - near)) * (1.0 - f32(near) / z)

    hw = batch + (height, width)
    rgba = torch.stack([c.reshape(hw) for c in chans]
                       + [torch.full(hw, 255.0, dtype=dtype, device=device)],
                       dim=-1)
    return rgba, depth.reshape(hw), seg.reshape(hw)
