"""Shared pieces of the tests/test_torch_*.py parity tests: the same
configuration built for the JAX package and for its PyTorch port, and
seeded numpy inputs pinned to float32 (conftest turns JAX x64 on, so an
array left untyped would become float64 on the JAX side)."""
import numpy as np
import torch

from gym_pybullet_drones_tpu import params as JP
from gym_pybullet_drones_tpu.envs import (
    AviaryConfig as JConfig, HoverTask as JHover,
    MultiHoverTask as JMultiHover, make_routing_config as j_routing_config)
from gym_pybullet_drones_tpu.utils import enums as JE

from gym_pybullet_drones_tpu_torch import params as TP
from gym_pybullet_drones_tpu_torch.envs import (
    AviaryConfig as TConfig, HoverTask as THover,
    MultiHoverTask as TMultiHover, make_routing_config as t_routing_config)
from gym_pybullet_drones_tpu_torch.ops import render_check
from gym_pybullet_drones_tpu_torch.utils import enums as TE

MODELS = ("cf2x", "cf2p", "racer")
ATOL, RTOL = 2e-5, 1e-4   # tests/test_fused.py's tolerance
# the embedded-PID paths: tests/test_fused.py:83-102 (atol 5e-5 on obs and
# reward) and tests/test_pallas.py:154-164 (rpm, state, PID rows)
PID_ATOL = 5e-5
RPM_TOL = dict(rtol=2e-5, atol=0.5)
PID_STATE_TOL = dict(rtol=3e-4, atol=3e-5)
PID_ROWS_TOL = dict(rtol=3e-4, atol=2e-5)


def models(name):
    """(JAX DroneParams, port DroneParams) of one drone model."""
    return JP.get_params(name), TP.get_params(name)


def pair(kind="hover", act="rpm", model="cf2x"):
    """((jax cfg, jax task), (port cfg, port task)) of the headline
    configurations: DYN, 240 Hz physics under 30 Hz control."""
    n = 2 if kind == "multihover" else 1
    jm, tm = models(model)
    jcfg = JConfig(drone=jm, num_drones=n, physics=JE.Physics.DYN,
                   pyb_freq=240, ctrl_freq=30)
    tcfg = TConfig(drone=tm, num_drones=n, physics=TE.Physics.DYN,
                   pyb_freq=240, ctrl_freq=30)
    jtask = (JMultiHover if n == 2 else JHover)(act=JE.ActionType(act))
    ttask = (TMultiHover if n == 2 else THover)(act=TE.ActionType(act))
    return (jcfg, jtask), (tcfg, ttask)


def routing_pair(n=3, spacing=0.5, **task_kw):
    """((jax cfg, jax task), (port cfg, port task)) of the routing fleet on
    DYN physics; `task_kw` replaces fields of both RoutingTasks."""
    import dataclasses
    jcfg, jtask = j_routing_config(n, spacing, physics=JE.Physics.DYN)
    tcfg, ttask = t_routing_config(n, spacing, physics=TE.Physics.DYN)
    return ((jcfg, dataclasses.replace(jtask, **task_kw)),
            (tcfg, dataclasses.replace(ttask, **task_kw)))


def rand_pid(b, seed, dtype=np.float32):
    """Seeded (last_rpy, integral_pos_e, integral_rpy_e) arrays (b, 3), at
    the sizes of tests/test_pallas.py's PID case."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(rng.normal(size=(b, 3)) * s, dtype)
                 for s in (0.05, 0.01, 0.1))


def rand_targets(b, seed, dtype=np.float32):
    """Seeded (target_pos, target_rpy (yaw only), target_vel,
    target_rpy_rates) arrays (b, 3)."""
    rng = np.random.default_rng(seed)
    tp = rng.normal(size=(b, 3)) * 0.5 + [0, 0, 1]
    trpy = np.concatenate([np.zeros((b, 2)), rng.normal(size=(b, 1)) * 0.5],
                          axis=-1)
    tv = rng.normal(size=(b, 3)) * 0.2
    return tuple(np.asarray(a, dtype) for a in (tp, trpy, tv,
                                                np.zeros((b, 3))))


def rand_dyn(b, seed, dtype=np.float32):
    """Seeded (pos, quat, vel, rpy_rates, ang_v) arrays of shape (b, k)
    around a hover, column 0 with zero rates (the keep branch)."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(b, 3)) * 0.3 + [0, 0, 1]
    quat = rng.normal(size=(b, 4)) * 0.1 + [0, 0, 0, 1]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    vel = rng.normal(size=(b, 3)) * 0.3
    rates = rng.normal(size=(b, 3))
    rates[0] = 0.0
    ang_v = rng.normal(size=(b, 3))
    return tuple(np.asarray(a, dtype) for a in (pos, quat, vel, rates, ang_v))


def rand_rpm(hover_rpm, b, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rpm = hover_rpm * (1 + 0.02 * rng.normal(size=(b, 4)))
    rpm[0] = hover_rpm
    return np.asarray(rpm, dtype)


# ---- RGB observations (ops/render.py against the JAX package's) ----
# The tie-aware comparison is the port's own (ops/render_check.py), the one
# the card's checks use; here it holds the port's images to the JAX
# package's.


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_render_close(got, ref, pos, fwd, arm):
    """(rgba, depth, seg) of the port against the JAX package's, same
    shapes, as `render_check.compare_render` holds them; returns its
    record (the counts of tied pixels among it)."""
    return render_check.compare_render(
        "render", tuple(_t(x) for x in got), tuple(_t(x) for x in ref),
        _t(pos), _t(fwd), arm)


def assert_obs_close(got, ref):
    """RGB observations (any shape ending in the 48*64*4 HWC values of a
    camera, or (.., 48, 64, 4)) without their seg and depth, as
    `render_check.obs_ties` holds them; returns the count of pixels
    beyond RGBA_ATOL."""
    return render_check.obs_ties("obs", _t(got), _t(ref))
