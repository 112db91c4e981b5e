"""The port's native DYN oracle (gym_pybullet_drones_tpu_torch/native/,
its own copy of dynamics_oracle.cpp, built with g++ into build/native/)
against the JAX package's build of the same C++: bit for bit, every drone
model; and against the port's own torch physics (`ops/dynamics.py`) in
float64.  No socket here: the bridge's tests are in
test_torch_beta_aviary.py."""
import os
import shutil

import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu import native as jnative
from gym_pybullet_drones_tpu import params as JP

from gym_pybullet_drones_tpu_torch import native as tnative
from gym_pybullet_drones_tpu_torch import params as TP
from gym_pybullet_drones_tpu_torch.ops.dynamics import DynState, dyn_step
from gym_pybullet_drones_tpu_torch.ops.quat import rpy_to_quat

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native oracle")
DT = 1 / 240


def _case(model, seed, b=3, t=120):
    rng = np.random.default_rng(seed)
    rpy = torch.tensor(rng.normal(size=(b, 3)) * 0.3, dtype=torch.float64)
    quat = rpy_to_quat(rpy).numpy()
    return (rng.normal(size=(b, 3)) + [0, 0, 1], quat,
            rng.normal(size=(b, 3)) * 0.5, rng.normal(size=(b, 3)),
            model.hover_rpm * (1 + 0.05 * rng.normal(size=(t, b, 4))))


@pytest.mark.parametrize("name", ["cf2x", "cf2p", "racer"])
def test_dyn_rollout_matches_jax_bitwise(name):
    pos, quat, vel, rates, rpms = _case(TP.get_params(name), 0)
    mine = tnative.dyn_rollout(TP.get_params(name), pos, quat, vel, rates,
                               rpms, DT, return_traj=True)
    ref = jnative.dyn_rollout(JP.get_params(name), pos, quat, vel, rates,
                              rpms, DT, return_traj=True)
    assert set(mine) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    assert mine["traj"].shape == (120, 3, 3)


def test_dyn_rollout_matches_torch_physics():
    """120 substeps of 3 CF2X drones: the C++ oracle against the port's
    `ops/dynamics.dyn_step` in float64."""
    model = TP.CF2X
    pos, quat, vel, rates, rpms = _case(model, 1)
    out = tnative.dyn_rollout(model, pos, quat, vel, rates, rpms, DT)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    s = DynState(pos=t(pos), quat=t(quat), vel=t(vel), rpy_rates=t(rates),
                 ang_v=torch.zeros(3, 3, dtype=torch.float64))
    for k in range(rpms.shape[0]):
        s = dyn_step(model, s, t(rpms[k]), DT)
    for k in ("pos", "quat", "vel", "rpy_rates", "ang_v"):
        np.testing.assert_allclose(getattr(s, k).numpy(), out[k],
                                   rtol=1e-9, atol=1e-10, err_msg=k)


def test_build_goes_to_the_build_dir():
    """The library lands in build/native/, named by the source's hash, and
    a second build reuses it."""
    path = tnative.build("dynamics_oracle")
    assert os.path.dirname(path) == tnative.build_dir()
    assert os.path.basename(path).startswith("libdynamics_oracle_")
    assert tnative.build("dynamics_oracle") == path
