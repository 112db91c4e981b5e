"""The trainer's minibatch step (`rl/ppo.py` `MinibatchSteps`): its one
body against the optax form of the optimizer step on the host's scalars,
the update's metrics and versions, the graph key, and on a card the
graphed update against the same body run eagerly.

The card test needs CUDA and skips elsewhere (`card`); it imports no JAX,
so on a machine without JAX it runs as
`python -m pytest --noconftest tests/test_torch_ppo_graph.py -q`."""
import dataclasses

import pytest
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask
from gym_pybullet_drones_tpu_torch.models.mlp import ActorCritic
from gym_pybullet_drones_tpu_torch.rl import PPOConfig, make_train
from gym_pybullet_drones_tpu_torch.rl import ppo as tppo
from gym_pybullet_drones_tpu_torch.rl.population import (
    make_train_population)
from gym_pybullet_drones_tpu_torch.utils import profiling
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)

CFG = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
TASK = HoverTask(act=ActionType.RPM)
SMALL = PPOConfig(num_envs=4, rollout_steps=4, num_minibatches=2,
                  update_epochs=2)


@pytest.fixture
def card():
    """A CUDA card; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed minibatch step exists "
                    "only there")
    return torch.device("cuda")


def reference_steps(ppo, net, opt_state, traj, advantages, returns, perms):
    """The minibatch steps as a plain loop on the host's scalars: each
    slice of each epoch's permutation gathered, the loss and its gradient,
    then `clip_adam_step` at `learning_rate(ppo)(count)` with its own bias
    corrections.  One policy (K = 1); (opt_state, the mean loss terms)."""
    members = torch.arange(1)[:, None]
    if ppo.sb3_minibatching:
        flat = lambda x: x.transpose(0, 1).reshape((1, -1) + x.shape[3:])
        traj = tppo.Transition(*map(flat, traj))
        advantages, returns = flat(advantages), flat(returns)
        gather = lambda x, take: x[members, take]
    else:
        gather = lambda x, take: x[take, members].transpose(1, 2).reshape(
            (1, -1) + x.shape[3:])
    mb = perms.shape[-1] // ppo.num_minibatches
    params = list(net.parameters())
    views = [p.detach()[None] for p in params]
    state = tppo.AdamState(opt_state.count,
                           [m[None] for m in opt_state.mu],
                           [v[None] for v in opt_state.nu])
    lr_at, aux = tppo.learning_rate(ppo), []
    for epoch in range(ppo.update_epochs):
        for i in range(ppo.num_minibatches):
            take = perms[:, epoch, i * mb:(i + 1) * mb]
            loss, terms = tppo.ppo_loss(
                net, tppo.Transition(*(gather(x, take) for x in traj)),
                gather(advantages, take), gather(returns, take), ppo)
            grads = torch.autograd.grad(loss.sum(), params)
            state = tppo.clip_adam_step(views, [g[None] for g in grads],
                                        state, lr_at(state.count),
                                        ppo.max_grad_norm)
            aux.append(torch.stack([x.detach() for x in terms]))
    return state, torch.stack(aux).mean(dim=0)


def random_rollout(gen, T, E, obs_dim, act_dim):
    draw = lambda *shape: torch.randn(shape, generator=gen)
    traj = tppo.Transition(
        draw(T, 1, E, obs_dim), draw(T, 1, E, act_dim), draw(T, 1, E),
        draw(T, 1, E), draw(T, 1, E),
        (torch.rand((T, 1, E), generator=gen) < 0.1).float())
    return traj, draw(T, 1, E), draw(T, 1, E)


@pytest.mark.parametrize("count,anneal,sb3", [
    (1, False, False), (2, False, False), (1000, False, False),
    (1000, True, False), (2, True, True)],
    ids=["count1", "count2", "count1000", "anneal1000", "anneal2-sb3"])
def test_step_body_matches_host_scalar_form(count, anneal, sb3):
    """The step body, its learning rate and bias corrections read from
    the update's table as 0-d tensors, against `clip_adam_step` on the
    host's floats in a plain loop: equal on the CPU at the first step
    counts 1, 2 and 1000 and under `anneal_lr` (8 x 4 samples, 2 x 2
    steps, a schedule 1200 steps long)."""
    T, E, obs_dim, act_dim = 8, 4, 6, 4
    ppo = PPOConfig(num_envs=E, rollout_steps=T, num_minibatches=2,
                    update_epochs=2, total_timesteps=300 * T * E,
                    anneal_lr=anneal, sb3_minibatching=sb3, lr=1e-2,
                    max_grad_norm=0.3)
    gen = torch.Generator().manual_seed(count)
    traj, advantages, returns = random_rollout(gen, T, E, obs_dim, act_dim)
    n = T * E if sb3 else T
    perms = torch.stack([torch.randperm(n, generator=gen)
                         for _ in range(ppo.update_epochs)])[None]
    sides = []
    for _ in range(2):
        net = ActorCritic(obs_dim, act_dim, hidden=(8, 8),
                          generator=torch.Generator().manual_seed(3))
        opt = tppo.adam_init(list(net.parameters()))
        # moments as a run that far would hold them
        opt = tppo.AdamState(count - 1, [torch.full_like(m, 1e-3)
                                         for m in opt.mu],
                             [torch.full_like(v, 1e-6) for v in opt.nu])
        sides.append((net, opt))
    (net, opt), (ref_net, ref_opt) = sides
    steps = tppo.MinibatchSteps(ppo, 1, lambda x: x[None])
    assert steps.key(net, opt, traj, perms) is None     # eager on the CPU
    opt, aux = steps(net, opt, traj, advantages, returns, perms)
    ref_opt, ref_aux = reference_steps(ppo, ref_net, ref_opt, traj,
                                       advantages, returns, perms)
    assert opt.count == ref_opt.count == count - 1 + 4
    assert torch.equal(aux, ref_aux)
    for got, want in zip(net.parameters(), ref_net.parameters()):
        assert torch.equal(got, want)
    for got, want in zip(opt.mu + opt.nu, ref_opt.mu + ref_opt.nu):
        assert torch.equal(got, want[0])


@pytest.fixture(scope="module")
def small():
    init, update, _, _ = make_train(CFG, TASK, SMALL, device="cpu")
    return init, update


def test_many_returns_each_updates_own_metrics(small):
    """`update.many` stacks one set of metrics an update, and an update's
    metrics stay as they were after later updates."""
    init, update = small
    ts = init(torch.Generator().manual_seed(1))
    ts, first = update(ts)
    kept = {k: v.clone() for k, v in first.items()}
    ts, history = update.many(ts, 3)
    for k, v in first.items():
        assert torch.equal(v, kept[k]), k
        assert history[k].shape == (3,)
    assert len(set(history["v_loss"].tolist())) == 3


def test_update_advances_every_version(small):
    """Each parameter's and Adam moment's `_version` advances across an
    update: autograd's in-place checks and a forward record keyed on the
    versions see the new weights."""
    init, update = small
    ts = init(torch.Generator().manual_seed(2))
    tensors = lambda ts: [*ts.network.parameters(), *ts.opt_state.mu,
                          *ts.opt_state.nu]
    before = [t._version for t in tensors(ts)]
    ts, _ = update(ts)
    assert all(t._version > v for t, v in zip(tensors(ts), before))


def test_graph_key_follows_the_state(small):
    """The key holds for a repeated update of one state and changes for a
    new `init`, a new `adam_init` and another rollout shape."""
    init, update = small
    ts = init(torch.Generator().manual_seed(3))
    T, E = SMALL.rollout_steps, SMALL.num_envs
    gen = torch.Generator().manual_seed(0)
    traj = random_rollout(gen, T, E, 72, 4)[0]
    perms = torch.zeros((1, SMALL.update_epochs, T), dtype=torch.long)
    key = lambda ts, traj=traj: tppo.graph_key(ts.network, ts.opt_state,
                                               traj, perms)
    k0 = key(ts)
    assert key(ts) == k0
    ts, _ = update(ts)
    assert key(ts) == k0
    assert key(init(torch.Generator().manual_seed(3))) != k0
    fresh = ts._replace(opt_state=tppo.adam_init(
        list(ts.network.parameters())))
    assert key(fresh) != k0
    longer = random_rollout(gen, 2 * T, E, 72, 4)[0]
    assert key(ts, longer) != k0


def card_trainer(kind: str, device):
    """(init, update, T, E, K) of the card test's trainers (K None: one
    policy), each 16 optimizer steps an update."""
    ppo = PPOConfig(num_envs=1024, rollout_steps=16, num_minibatches=4,
                    update_epochs=4)
    if kind == "population":
        ppo = dataclasses.replace(ppo, num_envs=256)
        return (*make_train_population(CFG, TASK, ppo, 2,
                                       device=device)[:2], 16, 256, 2)
    task = TASK
    if kind == "bf16":
        ppo = dataclasses.replace(ppo, compute_dtype="bfloat16")
    if kind == "cnn":
        task = dataclasses.replace(TASK, obs=ObservationType.RGB)
        ppo = dataclasses.replace(ppo, num_envs=16, rollout_steps=8)
    return (*make_train(CFG, task, ppo, device=device)[:2],
            ppo.rollout_steps, ppo.num_envs, None)


@pytest.mark.parametrize("kind", ["mlp", "population", "bf16", "cnn"])
def test_graphed_update_equals_eager_on_the_card(kind, card, monkeypatch):
    """Three updates with the minibatch step graphed against the same
    three through the eager body, from equal states and draws: weights,
    Adam's moments, the env carry, the observations and the metrics equal
    bit for bit; every step after the capture is a replay (15 of the
    first update's 16, then 16 of 16).  cuDNN's deterministic algorithms
    on both sides: the CNN's weight gradient may otherwise sum in another
    order from one call to the next."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    sides = {}
    for graphed in (True, False):
        if not graphed:
            monkeypatch.setattr(tppo, "step_graphable", lambda *a: False)
        init, update, T, E, K = card_trainer(kind, card)
        lead = () if K is None else (K,)
        ts = init(torch.Generator(card).manual_seed(11))
        gen = torch.Generator(card).manual_seed(12)
        history = []
        with profiling.recording() as rec:
            for _ in range(3):
                draws = tppo.Draws(
                    torch.randn(lead + (T, E, 4), generator=gen,
                                device=card),
                    torch.rand(lead + (4, T), generator=gen,
                               device=card).argsort(dim=-1))
                ts, metrics = update(ts, draws)
                history.append({k: v.clone() for k, v in metrics.items()})
        replays = [s[4]["graph_steps"] for s in rec.spans
                   if s[0] == "ppo.optimize"]
        sides[graphed] = ts, history, replays
    (ts, got, replays), (ref, want, ref_replays) = sides[True], sides[False]
    assert replays == [15, 16, 16] and ref_replays == [0, 0, 0]
    state = lambda ts: [*ts.network.parameters(), *ts.opt_state.mu,
                        *ts.opt_state.nu, *tppo.core.leaves(ts.env_state),
                        ts.last_obs]
    for a, b in zip(state(ts), state(ref), strict=True):
        assert torch.equal(a, b)
    assert ts.opt_state.count == ref.opt_state.count == 48
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
