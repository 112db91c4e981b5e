"""Raw engine scratchpad: poke the functional core directly.

    python -m gym_pybullet_drones_tpu_torch.examples.debug [--device cpu]

Counterpart of the JAX package's `examples/debug.py` (the reference's
examples/debug.py, a raw PyBullet scratchpad probing external forces and
torques): applies force/torque probes through the PYB-mode stepper
`ops/rigid_body.pyb_step` on `--device` (default the CUDA card) and prints
the resulting state — a template for experimenting with the engine
outside any task.  `probes(device)` returns the four final states.
"""
import argparse

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.ops.rigid_body import PybState, pyb_step
from gym_pybullet_drones_tpu_torch.utils.device import resolve_device

DT = 1 / 240


def probes(device=None, dtype=torch.float32) -> dict:
    """The four probes of the JAX package's debug.py, each from a hover at
    1 m with the hover rpm: no external force (1 s), 0.01 N along +x
    (0.5 s), 1e-5 N m about z (0.5 s), and flying +x at 0.5 m/s into the
    architrave beam and the test box (1 s).  Returns {probe: PybState}."""
    device = resolve_device(device)
    params = P.CF2X
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)
    state = PybState(pos=t([[0.0, 0.0, 1.0]]), quat=t([[0.0, 0.0, 0.0, 1.0]]),
                     vel=t([[0.0, 0.0, 0.0]]), ang_v=t([[0.0, 0.0, 0.0]]))
    rpm = torch.full((1, 4), params.hover_rpm, dtype=dtype, device=device)
    # Counterpart of the reference debug.py loading architrave.urdf and
    # box.urdf (reference examples/debug.py:19-20)
    obstacles = (
        P.load_obstacle_urdf(P.obstacle_asset_path("architrave"),
                             (0.5, 0.0, 1.0)),
        P.load_obstacle_urdf(P.obstacle_asset_path("box"), (1.0, 0.0, 0.05)),
    )
    runs = {"hover": (state, 240, {}),
            "force": (state, 120, {"ext_force": t([[0.01, 0.0, 0.0]])}),
            "torque": (state, 120, {"ext_torque": t([[0.0, 0.0, 1e-5]])}),
            "obstacle": (state._replace(vel=t([[0.5, 0.0, 0.0]])), 240,
                         {"obstacles": obstacles})}
    out = {}
    for name, (s, steps, kw) in runs.items():
        for _ in range(steps):
            s = pyb_step(params, s, rpm, DT, **kw)
        out[name] = s
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Probe the PYB stepper")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = probes(args.device)
    r = lambda x: np.round(x[0].cpu().numpy(), 4)
    print("== hover, no external force ==")
    print("after 1 s:", r(out["hover"].pos), "vel", r(out["hover"].vel))
    print("== external lateral force probe (0.01 N along +x for 0.5 s) ==")
    print("after 0.5 s:", r(out["force"].pos), "vel", r(out["force"].vel))
    print("== external torque probe (1e-5 N m about z) ==")
    print("ang_v after 0.5 s:", np.round(out["torque"].ang_v[0].cpu()
                                         .numpy(), 3))
    print("== obstacle contact probe (architrave beam + test box URDFs) ==")
    s = out["obstacle"]
    print("after 1 s flying +x into the beam: pos", r(s.pos),
          "(stopped short of x=0.5)" if float(s.pos[0, 0]) < 0.5 else "")
    return out


if __name__ == "__main__":
    main()
