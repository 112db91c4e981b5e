"""The routing learning run's evaluator (gym_pybullet_drones_tpu_torch/
rl/ppo.py `make_arrival_rate`) and `examples/train_to_threshold.py
--routing`, on the CPU.

The JAX evaluator is written here from scripts/train_to_threshold.py:128-150
(a closure inside `main` there: it cannot be imported, and the script
stays as it is), with two additions that change none of its arithmetic:
`use_pallas=False` (the XLA path the port is held against on the CPU) and
the network's input at every step, kept as the scan's output.  Both sides
take the same flax weights (`convert.actor_critic_state_dict_from_flax`)
on the routing configuration of the run (3 drones, spacing 0.4, PYB),
4 envs and a cut horizon.

- As configured (`arrival_tol` 0.05): no drone gets near its goal, the
  rate is 0 on both sides, and the obs the policy sees at every step agree
  to the embedded-PID paths' tolerance.
- With `arrival_tol` 1.7 and `arrival_hold` 1.0 in both packages alike and
  a mean head biased toward each drone's goal: `terminated` fires within
  the horizon on both sides, so the `ever` accounting is exercised.

Two free-running embedded-PID paths drift apart (the attitude gains
amplify the last bit; ROADMAP.md queue 3's watch list), so the obs are held
step by step over the first `HELD_STEPS` control steps only; measured in
the arrivals case: a world ang-vel column 1.9e-4 off on step 8, 7.4e-3 on
step 12, the other columns 3.2e-4 on step 13, the final positions
2.9e-6.  The rate, each env's flag and the final positions are held over
the whole horizon.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_pybullet_drones_tpu.envs import fast as jfast
from gym_pybullet_drones_tpu.envs import make_routing_config as j_routing
from gym_pybullet_drones_tpu.models import mlp as jmlp

from gym_pybullet_drones_tpu_torch import convert
from gym_pybullet_drones_tpu_torch.envs import make_routing_config as t_routing
from gym_pybullet_drones_tpu_torch.models import mlp as tmlp
from gym_pybullet_drones_tpu_torch.rl import make_arrival_rate

from tests._torch_helpers import PID_ATOL, RTOL

N_EVAL, HIDDEN = 4, (16, 16)
HELD_STEPS = 8
# the world ang-vel columns (9:12) of each drone's obs: the PYB family's
# tolerance (tests/test_pallas.py:241-259)
ANGV_TOL = (5e-4, 3e-4)


def _f32(tree):
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tree)


def _jax_arrival_rate(cfg, task, network, params, n_eval, horizon):
    """scripts/train_to_threshold.py:128-150, recording the obs each step
    feeds the policy."""
    er, es = jfast.make_batched_step(cfg, task, n_eval, autoreset=False,
                                     obs_layout="flat", use_pallas=False)

    def _arrival_rate(params, _key):
        st, obs = er()

        def step_fn(carry, _):
            st, obs, ever = carry
            mean, _, _ = network.apply(params, obs)
            act = mean.reshape(-1, cfg.num_drones,
                               task.action_dim(cfg))
            st, obs2, _, term, _ = es(st, act)
            return (st, obs2, ever | term), obs

        (st, _, ever), seen = jax.lax.scan(
            step_fn, (st, obs, jnp.zeros(n_eval, bool)), None,
            length=horizon)
        return jnp.mean(ever.astype(jnp.float32)), ever, st, seen
    return jax.jit(_arrival_rate)(params, None)


class _Recorder(torch.nn.Module):
    """The port's policy, keeping every obs it is given."""

    def __init__(self, net):
        super().__init__()
        self.net, self.seen = net, []

    def forward(self, obs):
        self.seen.append(obs.clone())
        return self.net(obs)


def _networks(task_kw, goal_bias):
    (jcfg, jtask) = j_routing(3, 0.4)
    (tcfg, ttask) = t_routing(3, 0.4)
    jtask = dataclasses.replace(jtask, **task_kw)
    ttask = dataclasses.replace(ttask, **task_kw)
    n, a = tcfg.num_drones, ttask.action_dim(tcfg)
    obs_dim = n * ttask.obs_dim(tcfg)
    jnet = jmlp.ActorCritic(action_dim=n * a, hidden=HIDDEN,
                            log_std_init=-1.0)
    params = _f32(jnet.init(jax.random.key(3),
                            jnp.zeros((1, obs_dim), jnp.float32)))
    if goal_bias:
        d = np.asarray(ttask.destinations) - np.asarray(tcfg.init_xyzs)
        bias = (d / np.linalg.norm(d, axis=-1, keepdims=True)).reshape(-1)
        params = jax.tree.map(lambda x: x, params)
        params["params"][f"Dense_{len(HIDDEN)}"]["bias"] = jnp.asarray(
            bias, jnp.float32)
    tnet = tmlp.ActorCritic(obs_dim, n * a, HIDDEN, log_std_init=-1.0)
    tnet.load_state_dict(convert.actor_critic_state_dict_from_flax(params))
    return (jcfg, jtask, jnet, params), (tcfg, ttask, tnet)


@pytest.mark.parametrize("task_kw,goal_bias,horizon,rate", [
    ({}, False, 8, 0.0),
    ({"arrival_tol": 1.7, "arrival_hold": 1.0}, True, 14, 1.0)],
    ids=["as_configured", "arrivals"])
def test_arrival_rate_matches_jax(task_kw, goal_bias, horizon, rate):
    (jcfg, jtask, jnet, params), (tcfg, ttask, tnet) = _networks(
        task_kw, goal_bias)
    jrate, jever, jst, jseen = _jax_arrival_rate(jcfg, jtask, jnet, params,
                                                 N_EVAL, horizon)
    rec = _Recorder(tnet)
    trate, tever, tst = make_arrival_rate(tcfg, ttask, N_EVAL, horizon,
                                          "cpu")(rec)
    assert float(trate) == float(jrate) == rate
    np.testing.assert_array_equal(tever.numpy(), np.asarray(jever))
    # the obs the policy saw, step by step
    assert len(rec.seen) == horizon
    per = ttask.obs_dim(tcfg)
    atol = np.full(3 * per, PID_ATOL)
    rtol = np.full(3 * per, RTOL)
    for d in range(3):
        atol[d * per + 9:d * per + 12] = ANGV_TOL[0]
        rtol[d * per + 9:d * per + 12] = ANGV_TOL[1]
    for t, (o, jo) in enumerate(zip(rec.seen[:HELD_STEPS],
                                    np.asarray(jseen))):
        assert np.all(np.abs(o.numpy() - jo) <= atol + rtol * np.abs(jo)), \
            (t, float(np.abs(o.numpy() - jo).max()))
    np.testing.assert_allclose(tst.pos.numpy(),
                               np.asarray(jst.pos).reshape(-1, 3),
                               atol=PID_ATOL, rtol=RTOL)
    # every env flew the same deterministic episode
    pos = tst.pos.reshape(N_EVAL, 3, 3)
    assert torch.equal(pos, pos[:1].expand_as(pos))


def test_train_to_threshold_routing_writes_the_jax_fields(tmp_path,
                                                         monkeypatch):
    """`--routing` at a tiny size, one update: the JSON carries the JAX
    script's routing fields and the port's own.  The evaluation asks for
    the run's 64 envs x 480 control steps; on the CPU (0.3 s a control
    step of the plain PYB rows) it is cut to 2 envs x 2 steps here, and
    held whole by the test above."""
    from gym_pybullet_drones_tpu_torch.examples import train_to_threshold
    asked = []

    def cut(cfg, task, num_envs, horizon, device):
        asked.append((num_envs, horizon))
        return make_arrival_rate(cfg, task, 2, 2, device)
    monkeypatch.setattr(train_to_threshold, "make_arrival_rate", cut)
    out = tmp_path / "routing.json"
    rc = train_to_threshold.main([
        "--routing", "--device", "cpu", "--max_updates", "1",
        "--num_envs", "2", "--rollout_steps", "4", "--epochs", "1",
        "--hidden", "8", "--log_std_init", "-1", "--anneal",
        "--out", str(out)])
    rec = json.loads(out.read_text())
    assert asked == [(64, 480)]
    assert rc == 1 and not rec["reached"]
    for k, v in {"task": "routing", "metric": "all_arrivals_rate",
                 "action_type": "pid_waypoint", "obs_type": "kin",
                 "physics": "pyb", "target_reward": 0.9,
                 "platform": "cpu"}.items():
        assert rec[k] == v, k
    assert rec["reference_source"].startswith(
        "gym_pybullet_drones/envs/BaseAviary.py:1105-1147")
    assert rec["ppo"]["num_envs"] == 2 and rec["ppo"]["log_std_init"] == -1
    assert len(rec["curve"]) == 1
    assert rec["curve"][0]["eval_return"] == 0.0
    assert rec["env_path"] == "fused"
