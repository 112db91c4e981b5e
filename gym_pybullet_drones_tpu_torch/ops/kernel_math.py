"""Row-wise Euler extraction shared by the plain versions of the kernels.

Counterpart of the JAX package's `ops/pallas_math.py`.  That module is a
Cephes polynomial only because its compiler has no inverse-trig lowering;
here the plain versions use `torch.atan2` / `torch.asin` and the CUDA
device function `gpd_quat_rpy` (csrc/drone_kernels.cuh) uses `atan2f` /
`asinf`.  The kernel's conventions are kept: the un-normalized quadratic
terms feed atan2 directly (it is scale invariant), and the asin argument
is divided by the squared norm and clipped.

One difference from the polynomial is known and accepted: for a signed
zero, `atan2(-0, x < 0)` is -pi here and +pi there (the polynomial treats
-0 as non-negative).  It needs an exactly inverted drone with an exactly
zero cross term.

The DSL-PID tick (`ops/kernel_pid.pid_tick_rows`, `gpd_pid_tick`) takes the
target attitude's Euler angles the same way, `atan2(-z_ax[1], z_ax[2])` and
`atan2(-y_ax[0], x_ax[0])`, and there a first argument of -0.0 is the
normal case: a level thrust vector has z_ax[1] = +0 and a zero yaw target
has y_ax[0] = +0, both negated.  The second arguments are positive then
(thrust points up, the target x axis points along +x), and for a positive
second argument both conventions return the signed zero itself, which the
sin/cos that follow do not tell apart.  They would differ only for a
thrust vector pointing down (z_ax[2] < 0) with exactly no y component, or
a yaw target beyond 90 degrees that makes y_ax[0] exactly zero, i.e. a yaw
target of exactly pi.  Its `asin(z_ax[0])` is clipped to [-1, 1] first:
`torch.asin` and `asinf` return NaN for 1 + 1 ulp, which the normalisation
can leave, where the polynomial clipped its own argument.
"""
from __future__ import annotations

import torch


def quat_rpy_rows(qx: torch.Tensor, qy: torch.Tensor, qz: torch.Tensor,
                  qw: torch.Tensor):
    """Roll/pitch/yaw rows from (possibly un-normalized) quaternion rows."""
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    roll = torch.atan2(2.0 * (qw * qx + qy * qz),
                       n2 - 2.0 * (qx * qx + qy * qy))
    pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx) / n2, -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy),
                      n2 - 2.0 * (qy * qy + qz * qz))
    return roll, pitch, yaw
