"""How two renders of the same cameras are held against each other.

Two float32 renderers that round a step differently (FMA contraction, a
vector square root, XLA's fusions) can flip a pixel that sits at a tie: a
ray grazing a silhouette, two surfaces met at one distance (the cube
standing on the plane), a ground hit within rounding of a tile line.  Such
a pixel may differ, on at most TIE_SHARE of a batch's pixels; elsewhere
rgba agrees within RGBA_ATOL and depth within DEPTH_ATOL.  A floored-modulo
or a normal-sign fault paints whole tiles or faces wrong, far beyond the
share.

The card's checks (`chip_smoke.py`: the render kernel against
`ops/render.py`) and the CPU tests (the port's renderer against the JAX
package's) use these functions; they take tensors on any device.
"""
from __future__ import annotations

import math

import torch

RGBA_ATOL = 1.0          # of 255, on pixels of the same object
DEPTH_ATOL = 1e-5        # depth-buffer units, on pixels of the same object
TIE_SHARE = 1e-3         # pixels that may differ at a tie, of a batch
CHECKER_TIE = 1e-4       # [m] per metre of ray: a ground hit this close to a
                         # tile line is at a tie


def checker_ties(pos, fwd, arm, width=64, height=48):
    """(C, H, W) bool: the ground hit of a pixel's ray lies within
    CHECKER_TIE * max(1, t) of a tile line, computed in float64 for C
    cameras at `pos` (C, 3) looking along `fwd` (C, 3), the eye `arm`
    above the camera."""
    pos, fwd = pos.double(), fwd.double()
    th = math.tan(math.radians(30.0))
    ar = lambda n: torch.arange(n, dtype=torch.float64, device=pos.device)
    xs = (2 * (ar(width) + 0.5) / width - 1) * th
    ys = (1 - 2 * (ar(height) + 0.5) / height) * th
    r = torch.stack([fwd[:, 1], -fwd[:, 0], torch.zeros_like(fwd[:, 0])], -1)
    r = r / r.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    u = torch.linalg.cross(r, fwd)
    e = lambda a: a[:, None, None, :]
    d = e(fwd) + xs[None, None, :, None] * e(r) + ys[None, :, None, None] \
        * e(u)
    d = d / d.norm(dim=-1, keepdim=True)
    dz = torch.where(d[..., 2].abs() > 1e-12, d[..., 2], 1e-12)
    t = -(pos[:, 2] + arm)[:, None, None] / dz
    hp = pos[:, None, None, :2] + t[..., None] * d[..., :2]
    gap = (hp - hp.round()).abs().min(dim=-1).values
    return (t > 0) & (gap <= CHECKER_TIE * t.clamp(min=1.0))


def seg_edges(seg):
    """(C, H, W) bool: a pixel with a 4-neighbour of another object."""
    edge = torch.zeros_like(seg, dtype=torch.bool)
    dx = seg[:, :, 1:] != seg[:, :, :-1]
    dy = seg[:, 1:, :] != seg[:, :-1, :]
    edge[:, :, 1:] |= dx
    edge[:, :, :-1] |= dx
    edge[:, 1:, :] |= dy
    edge[:, :-1, :] |= dy
    return edge


def compare_render(name, got, ref, pos, fwd, arm):
    """Hold (rgba, depth, seg) `got` against `ref`, the same cameras: seg
    (..., H, W), depth alike, rgba (..., H, W, 4) or its flattened HWC
    rows; `pos` and `fwd` (..., 3) the cameras, `arm` the eye's height
    above them.  seg may differ only at a tie (the depths within
    DEPTH_ATOL, or an edge of `ref`'s segmentation), a ground pixel may
    take the other grey only at a checker tie, such pixels are at most
    TIE_SHARE of the batch; elsewhere rgba within RGBA_ATOL and depth
    within DEPTH_ATOL.  Raises AssertionError naming `name`; returns the
    record of what was compared."""
    (ga, gd, gs), (ra, rd, rs) = got, ref
    h, w = rs.shape[-2:]
    flat = lambda x, *tail: torch.as_tensor(x).reshape((-1,) + tail)
    ga, ra = flat(ga, h, w, 4), flat(ra, h, w, 4).to(ga.device)
    gd, rd = flat(gd, h, w), flat(rd, h, w).to(gd.device)
    gs, rs = flat(gs, h, w), flat(rs, h, w).to(gs.device)
    pos, fwd = flat(pos, 3).to(gs.device), flat(fwd, 3).to(gs.device)
    if ga.shape != ra.shape or gs.shape != rs.shape or gd.shape != rd.shape:
        raise AssertionError(f"{name}: shapes {tuple(ga.shape)} and "
                             f"{tuple(ra.shape)}")
    if not (torch.isfinite(ga).all() and (ga[..., 3] == 255).all()
            and ga.min() >= 0 and ga.max() <= 255):
        raise AssertionError(f"{name}: rgba out of range")
    seg_diff = gs != rs
    tie = (gd - rd).abs() <= DEPTH_ATOL
    if (seg_diff & ~tie & ~seg_edges(rs)).any():
        raise AssertionError(f"{name}: a pixel changed object away from a "
                             "tie")
    same = ~seg_diff
    rgba_err = (ga - ra).abs().max(dim=-1).values
    bad = (rgba_err > RGBA_ATOL) & same
    checker = bad & (rs == 0) & checker_ties(pos, fwd, arm, w, h)
    if (bad & ~checker).any():
        raise AssertionError(f"{name}: rgba beyond {RGBA_ATOL} away from a "
                             f"tie: {float(rgba_err[bad & ~checker].max())}")
    depth_err = float((gd - rd).abs()[same].max())
    if depth_err > DEPTH_ATOL:
        raise AssertionError(f"{name}: depth {depth_err} beyond {DEPTH_ATOL}")
    tied = int(seg_diff.sum() + checker.sum())
    if tied > TIE_SHARE * rs.numel():
        raise AssertionError(f"{name}: {tied} pixels at ties of "
                             f"{rs.numel()}")
    keep = same & ~checker
    return {"rgba_max_abs_err": float(rgba_err[keep].max()),
            "depth_max_abs_err": depth_err,
            "seg_differ": int(seg_diff.sum()),
            "checker_ties": int(checker.sum()),
            "tie_share": tied / rs.numel(),
            "bitwise_equal": bool(torch.equal(ga, ra) and torch.equal(gd, rd)
                                  and torch.equal(gs, rs))}


def obs_ties(name, got, ref):
    """RGB observations without their seg and depth (any shapes holding
    the same HWC values): rgba within RGBA_ATOL but on at most TIE_SHARE
    of the pixels.  Raises AssertionError naming `name`; returns the count
    of pixels beyond."""
    got = torch.as_tensor(got).float()
    ref = torch.as_tensor(ref).float().to(got.device)
    if got.numel() != ref.numel():
        raise AssertionError(f"{name}: {got.numel()} values against "
                             f"{ref.numel()}")
    bad = (got.reshape(-1, 4) - ref.reshape(-1, 4)).abs().max(dim=-1).values \
        > RGBA_ATOL
    n = int(bad.sum())
    if n > TIE_SHARE * bad.numel():
        raise AssertionError(f"{name}: {n} pixels beyond {RGBA_ATOL} of "
                             f"{bad.numel()}")
    return n
