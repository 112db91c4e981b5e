"""Port ops/dynamics.py against the JAX package's: the mixer in both its
float64 left-to-right and float32 factored forms, and `dyn_step`, for all
three drone models."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gym_pybullet_drones_tpu.ops import dynamics as jd
from gym_pybullet_drones_tpu_torch.ops import dynamics as td

from tests._torch_helpers import MODELS, models, rand_dyn, rand_rpm

TOL = {np.float64: 1e-12, np.float32: 1e-6}
B = 32


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", MODELS)
def test_motor_forces_torques_matches_jax(model, dtype):
    jm, tm = models(model)
    rpm = rand_rpm(jm.hover_rpm, B, seed=5, dtype=dtype)
    jf, jt = jd.motor_forces_torques(jm, jnp.asarray(rpm))
    tf, tt = td.motor_forces_torques(tm, torch.from_numpy(rpm))
    # relative: thrusts are ~0.07 N, torques ~1e-6 N m
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=TOL[dtype],
                               atol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=TOL[dtype],
                               atol=TOL[dtype] * 1e-6)
    # equal rpms: the torques cancel exactly (row 0 is a pure hover)
    assert np.all(tt.numpy()[0] == 0.0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("model", MODELS)
def test_dyn_step_matches_jax(model, dtype):
    jm, tm = models(model)
    leaves = rand_dyn(B, seed=7, dtype=dtype)
    rpm = rand_rpm(jm.hover_rpm, B, seed=8, dtype=dtype)
    js = jd.DynState(*(jnp.asarray(a) for a in leaves))
    ts = td.DynState(*(torch.from_numpy(a) for a in leaves))
    for _ in range(4):
        js = jd.dyn_step(jm, js, jnp.asarray(rpm), 1 / 240)
        ts = td.dyn_step(tm, ts, torch.from_numpy(rpm), 1 / 240)
    for name in td.DynState._fields:
        got, ref = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        assert got.dtype == dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("name", MODELS)
def test_urdf_asset_roundtrip(name):
    """tests/test_dynamics.py:170's check on the port: its own copy of each
    drone URDF parses back (`from_urdf(asset_path(m), m)`) to the exact
    built-in table, and the copy is byte for byte the JAX package's."""
    import os
    from gym_pybullet_drones_tpu import params as JP
    from gym_pybullet_drones_tpu_torch import params as TP
    prm = TP.get_params(name)
    path = TP.asset_path(prm.model)
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(TP.__file__), "assets")
    assert TP.from_urdf(path, prm.model) == prm
    with open(path, "rb") as mine, open(JP.asset_path(name), "rb") as ref:
        assert mine.read() == ref.read()
