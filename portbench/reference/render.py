"""The plain reference's camera: each drone's ray-traced RGBA image, its
depth buffer and segmentation, in plain PyTorch.

A frozen copy of the arithmetic of the port's plain ray tracer, operation
for operation: every vector sum in its written order (no `linalg.norm`,
no `cross`), the image-plane offsets divided by tensors (torch on CUDA
multiplies by the reciprocal of a Python-number divisor, which is not the
division the port rounds), the checker's floored modulo (`remainder`:
-1 mod 2 is 1), the closest hit a running minimum in which the first
primitive wins a tie (landmark spheres, drone spheres, boxes, plane).
The scene, its shading and the camera come from the configuration file
(`scene`, `camera`, and the drone's arm `l`, which is both the eye's
height above the drone and the near plane, as upstream
`BaseAviary._getDroneImages` sets them: eye at pos + [0, 0, L], looking
along the body +x axis, up [0, 0, 1], vertical field of view 60 degrees,
aspect 1, near L, far 1000); nothing is taken from the program.

Departures from upstream, written in the file's `assumed`: its landmarks
are pybullet_data meshes (a block, a cube, a duck, a teddy), drawn here
as coloured boxes and spheres; its renderer is TinyRenderer's rasteriser,
whose shading (ambient 0.6, diffuse 0.35) is kept with one pinned light
direction.
"""
from __future__ import annotations

import math

import torch

BIG = 1e9


def camera_forward(quat: torch.Tensor) -> torch.Tensor:
    """The view direction (..., 3) of cameras with attitude `quat` (...,
    4), xyzw: the first column of the normalised quaternion's rotation."""
    x, y, z, w = (quat[..., k] for k in range(4))
    n = torch.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                        2 * (x * z - w * y)], dim=-1)


def unit_light(light_dir, dtype, device) -> torch.Tensor:
    light = torch.tensor(light_dir, dtype=dtype, device=device)
    x, y, z = light
    return light / torch.sqrt(x * x + y * y + z * z)


def render_along(config: dict, cam_pos, forward, drone_pos):
    """Cameras at `cam_pos` (..., 3) looking along the unit `forward`
    (..., 3), with the env's drones `drone_pos` (..., M, 3) drawn as
    spheres of radius 2L (not for a camera within 3L of one: the eye sits
    in its own body): (rgba (..., H, W, 4) in [0, 255], depth (..., H, W)
    buffer values, seg (..., H, W) int32)."""
    scene, camera = config["scene"], config["camera"]
    arm = float(config["drone"]["l"])
    width, height = int(camera["width"]), int(camera["height"])
    far = float(camera["far"])
    dtype, device = cam_pos.dtype, cam_pos.device
    batch = cam_pos.shape[:-1]
    npix = height * width
    f32 = lambda x: torch.tensor(x, dtype=dtype, device=device)

    def a1(x):
        return x[..., None]

    eye = cam_pos + f32([0.0, 0.0, arm])
    ox, oy, oz = a1(eye[..., 0]), a1(eye[..., 1]), a1(eye[..., 2])

    f0, f1, f2 = (forward[..., k] for k in range(3))
    u0, u1, u2 = 0.0, 0.0, 1.0
    r0, r1, r2 = f1 * u2 - f2 * u1, f2 * u0 - f0 * u2, f0 * u1 - f1 * u0
    rn = torch.clamp(torch.sqrt(r0 * r0 + r1 * r1 + r2 * r2), min=1e-6)
    r0, r1, r2 = r0 / rn, r1 / rn, r2 / rn
    c0, c1, c2 = r1 * f2 - r2 * f1, r2 * f0 - r0 * f2, r0 * f1 - r1 * f0

    tan_half = math.tan(math.radians(float(camera["fov_deg"])) / 2)
    ar = lambda n: torch.arange(n, dtype=dtype, device=device)
    xs = (2 * (ar(width) + 0.5) / f32(float(width)) - 1) * tan_half
    ys = (1 - 2 * (ar(height) + 0.5) / f32(float(height))) * tan_half
    px = xs.repeat(height)
    py = ys.repeat_interleave(width)

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

    spheres = scene["spheres"]
    if spheres:
        sc = f32([s["center"] for s in spheres])
        sr = f32([s["radius"] for s in spheres])
    for i, s in enumerate(spheres):
        sphere(sc[i, 0], sc[i, 1], sc[i, 2], sr[i], f32(s["color"]),
               int(s["id"]))

    drone_col = f32(scene["drone_color"])
    for m in range(drone_pos.shape[-2]):
        dpx, dpy, dpz = (drone_pos[..., m, k] for k in range(3))
        ex, ey, ez = (dpx - cam_pos[..., 0], dpy - cam_pos[..., 1],
                      dpz - cam_pos[..., 2])
        dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
        r = torch.where(dist < 3 * arm, f32(0.0), f32(2 * arm))
        sphere(a1(dpx), a1(dpy), a1(dpz), a1(r), drone_col,
               int(scene["drone_id"]) + m)

    boxes = scene["boxes"]
    if boxes:
        bc = f32([b["center"] for b in boxes])
        bh = f32([b["half"] for b in boxes])
    for i, box in enumerate(boxes):
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
        is_x = (tx >= ty) & (tx >= tz)
        is_y = (~is_x) & (ty >= tz)
        nx = torch.where(is_x, -torch.sign(dx), 0.0)
        ny = torch.where(is_y, -torch.sign(dy), 0.0)
        nz = torch.where(is_x | is_y, 0.0, -torch.sign(dz))
        consider(t, nx, ny, nz, f32(box["color"]), int(box["id"]))

    checker = scene["checker"]
    t_p = torch.where(torch.abs(dz) > 1e-6, -oz / dz, BIG)
    t_p = torch.where(t_p > 1e-4, t_p, BIG)
    hpx, hpy = ox + t_p * dx, oy + t_p * dy
    odd = torch.remainder(torch.floor(hpx) + torch.floor(hpy), 2)
    pc = torch.where(odd > 0.5, f32(checker[0]), f32(checker[1]))
    consider(t_p, zero, zero, torch.ones_like(zero), (pc, pc, pc), 0)

    t_best = best["t"]
    hit_mask = t_best < far
    seg = torch.where(hit_mask, best["id"], -1)

    light = unit_light(scene["light_dir"], dtype, device)
    lam = torch.clamp(best["nx"] * light[0] + best["ny"] * light[1]
                      + best["nz"] * light[2], min=0.0)
    shade = float(scene["ambient"]) + float(scene["diffuse"]) * lam
    sky = f32(scene["sky"])
    chans = [torch.clamp(torch.where(hit_mask, shade * best[c], sky[k])
                         * 255.0, 0, 255)
             for k, c in enumerate(("cr", "cg", "cb"))]

    z = torch.clamp(t_best, arm, far)
    depth = (far / (far - arm)) * (1.0 - f32(arm) / z)

    hw = batch + (height, width)
    rgba = torch.stack([c.reshape(hw) for c in chans]
                       + [torch.full(hw, 255.0, dtype=dtype, device=device)],
                       dim=-1)
    return rgba, depth.reshape(hw), seg.reshape(hw)


def render_drones(config: dict, pos: torch.Tensor, quat: torch.Tensor,
                  group: int):
    """The camera of each of C drones at `pos` (C, 3) with attitude `quat`
    (C, 4), in envs of `group` drones that see each other: (rgba rows
    (C, H*W*4) in HWC order, depth (C, H, W), seg (C, H, W))."""
    c = pos.shape[0]
    b = c // group
    fwd = camera_forward(quat)
    rgba, depth, seg = render_along(
        config, pos.reshape(b, group, 3), fwd.reshape(b, group, 3),
        pos.reshape(b, 1, group, 3))
    h, w = depth.shape[-2:]
    return (rgba.reshape(c, h * w * 4), depth.reshape(c, h, w),
            seg.reshape(c, h, w))
