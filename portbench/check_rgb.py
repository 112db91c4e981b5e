"""The numbers of the pixel trainer's check that `check.py` does not
compute: the policy's forward passes against the reference's NatureCNN,
and the program's images against the reference's camera.

- `policy_gap`: every kept forward pass of the rollout's policy (the
  hook's rows of each call, at that call's weights, as the program
  computed them) against the reference's forward pass of the same rows
  and weights in IEEE float32: the largest gap of the Gaussian mean or
  the value over the largest |reference| of that output over the calls
  at those weights (an update's 33 calls).  `check.policy_gap` divides
  by a call's own largest |reference|; here every env of the batch holds
  one state after a reset (all of them at once, at the start and at the
  episode's timeout), so a call's kept rows can all be one image, whose
  output may lie near zero by chance.
- `image_err` and `image_tie_share`: images the program fed its policy,
  each against the reference's render of the program's own state (the
  state the image is of, so both sides hold it exactly), by the tie rule
  of the port's render check, copied here: two float32 renderers that
  round a step differently may flip a pixel at a tie (a ray grazing a
  silhouette, a ground hit within rounding of a tile line), and only
  there.  `image_err` is the largest rgba error (of 255) over the pixels
  that are not at a tie of the reference's image (an edge of its
  segmentation, or a ground pixel whose ray meets the ground within
  CHECKER_TIE a metre of ray of a tile line); `image_tie_share` the share
  of all compared pixels whose rgba differs by more than RGBA_ATOL.
"""
from __future__ import annotations

import math

import torch

from portbench.reference import cnn as ref_cnn
from portbench.reference import render as ref_render

RGBA_ATOL = 1.0          # of 255: a pixel beyond it differs
CHECKER_TIE = 1e-4       # [m] per metre of ray, as the port's render check


def policy_gap(calls: list, config: dict, device) -> float:
    """The largest gap over the kept calls, each a dict of `weights` (one
    dict for all the calls at one set of weights), the input rows `obs`,
    and the program's `mean` and `value` on them."""
    gaps, scale = [], {}
    with ref_cnn.float32(), torch.no_grad():
        for c in calls:
            w = {k: v.to(device).float() for k, v in c["weights"].items()}
            mean, _, value = ref_cnn.forward(w, c["obs"].to(device).float(),
                                             config)
            for out, (p, r) in enumerate(((c["mean"], mean),
                                          (c["value"], value))):
                r = r.double()
                key = (id(c["weights"]), out)
                scale[key] = max(scale.get(key, 0.0), float(r.abs().max()))
                gaps.append((key, float((p.to(device).double().reshape(
                    r.shape) - r).abs().max())))
    worst = 0.0
    for key, gap in gaps:
        g = gap / scale[key]
        worst = max(worst, g if math.isfinite(g) else math.inf)
    return worst


def checker_ties(pos, fwd, arm, fov_deg, width, height):
    """(C, H, W) bool: the ground hit of a pixel's ray lies within
    CHECKER_TIE * max(1, t) of a tile line, computed in float64 for C
    cameras at `pos` (C, 3) looking along `fwd` (C, 3), the eye `arm`
    above the camera."""
    pos, fwd = pos.double(), fwd.double()
    th = math.tan(math.radians(fov_deg) / 2)
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


def image_numbers(images: list, config: dict, device) -> dict:
    """`image_err` and `image_tie_share` over `images`, each a dict of the
    program's image rows `obs` (C, H*W*C') and the state they are of:
    the cameras' `pos` (C, 3) and `quat` (C, 4), one drone an env."""
    cam = config["camera"]
    h, w = int(cam["height"]), int(cam["width"])
    arm = float(config["drone"]["l"])
    worst, beyond, total = 0.0, 0, 0
    for im in images:
        pos = im["pos"].to(device).float()
        quat = im["quat"].to(device).float()
        rgba, _, seg = ref_render.render_drones(config, pos, quat, 1)
        got = im["obs"].to(device).float().reshape(-1, h, w, 4)
        diff = (got - rgba.reshape(-1, h, w, 4)).abs().amax(dim=-1)
        diff = torch.nan_to_num(diff, nan=math.inf)
        tie = seg_edges(seg) | ((seg == 0) & checker_ties(
            pos, ref_render.camera_forward(quat), arm,
            float(cam["fov_deg"]), w, h))
        off = diff[~tie]
        if off.numel():
            worst = max(worst, float(off.max()))
        beyond += int((diff > RGBA_ATOL).sum())
        total += diff.numel()
    return {"image_err": worst,
            "image_tie_share": beyond / total if total else math.inf}
