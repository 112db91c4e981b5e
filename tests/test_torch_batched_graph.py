"""`make_batched_step`'s control step under CUDA graphs (`envs/fast.py`
`_StepGraph` over `utils/graphs.py` `Segments`): the choice of graph or
eager from the device and the task, the span attribute `graphed`, and on
a card the graphed step against the same body run eagerly, bit for bit,
over auto-resets, with each kernel launched and counted on every step.

On the host the graph's bookkeeping runs with a stand-in for `Segments`
whose replay runs the step again on the static tensors (`host_graph`):
the static state and action, the copies in and the clones out, the state
the static state holds, the fallback to the eager step for a state laid
out otherwise.  The card tests need CUDA and skip elsewhere (`card`); the
file imports no JAX, so on a machine without it run it as
`python -m pytest --noconftest tests/test_torch_batched_graph.py -q`."""
import dataclasses

import pytest
import torch

from gym_pybullet_drones_tpu_torch import params as P
from gym_pybullet_drones_tpu_torch.envs import AviaryConfig, HoverTask, core
from gym_pybullet_drones_tpu_torch.envs import fast
from gym_pybullet_drones_tpu_torch.envs.routing import make_routing_config
from gym_pybullet_drones_tpu_torch.ops import (
    kernel_dyn, kernel_env, kernel_pid, kernel_render)
from gym_pybullet_drones_tpu_torch.utils import graphs, profiling
from gym_pybullet_drones_tpu_torch.utils.enums import (
    ActionType, ObservationType, Physics)

DYN = AviaryConfig(P.CF2X, 1, Physics.DYN, 240, 30)
# 0.25 s episodes: every env truncates on control step 8, so a dozen
# steps hold an auto-reset
RGB = HoverTask(act=ActionType.ONE_D_RPM, obs=ObservationType.RGB,
                episode_len_sec=0.25)
KIN = HoverTask(act=ActionType.RPM, episode_len_sec=0.25)
NOISY = dataclasses.replace(KIN, reset_pos_noise=0.05)
# the kernel wrappers a batched step calls, each with its `launches`
KERNELS = (kernel_dyn, kernel_pid, kernel_env, kernel_render)


@pytest.fixture
def card():
    """A CUDA card; the test is skipped where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed batched step exists "
                    "only there")
    return torch.device("cuda")


class HostSegments:
    """The stand-in for `utils.graphs.Segments`: a replay runs the
    step."""

    def __init__(self, replay):
        self.replay = replay


@pytest.fixture
def host_graph(monkeypatch):
    """The graphed path on the host: `batched_step_graphable`'s rule as on
    a card, and a capture that runs the step on static tensors laid out as
    its results and keeps it for `HostSegments`' replays, which write the
    next state over the state and the rest over the first replay's
    results, as a replay of the graphs does."""
    rule = fast.batched_step_graphable

    def capture(cls, body, flat, a):
        result = body(flat, a)
        state = core.map_leaves(torch.empty_like, result.state)
        action = a.clone(memory_format=torch.contiguous_format)
        kept = []

        def replay():
            got = body(state, action, into=state)
            for dst, src in zip(core.leaves(state), core.leaves(got.state)):
                dst.copy_(src)
            if kept:
                for dst, src in zip(kept[0][1:], got[1:]):
                    dst.copy_(src)
            else:
                kept.append(got._replace(state=state))
        replay()
        return result, cls(HostSegments(replay), action, kept[0])
    monkeypatch.setattr(fast, "batched_step_graphable",
                        lambda device, task: rule(torch.device("cuda"), task))
    monkeypatch.setattr(fast._StepGraph, "capture", classmethod(capture))


def rollout(cfg, task, envs, steps, device, autoreset=True, restart=None,
            after_first=None):
    """`steps` calls of the batched step from its reset on actions drawn
    from seed 5: each call's results (state, obs, reward, term, trunc),
    copies of their leaves taken as the call returned, and the `graphed`
    attribute of each call's span.  At step `restart` the call gets the
    reset state again; `after_first()` runs after the first call and
    what it returns is kept until the last."""
    reset_fn, step_fn = fast.make_batched_step(
        cfg, task, envs, autoreset=autoreset, obs_layout="flat",
        device=device)
    gen = torch.Generator(device).manual_seed(5)
    start, _ = reset_fn()
    state = start
    shape = (envs, cfg.num_drones, task.action_dim(cfg))
    results, kept = [], []
    with profiling.recording() as rec:
        for t in range(steps):
            action = torch.rand(shape, generator=gen, device=device) * 2 - 1
            got = step_fn(start if t == restart else state, action)
            results.append(got)
            kept.append([x.clone() for x in leaves(got)])
            state = got[0]
            if t == 0 and after_first is not None:
                held = after_first()
    graphed = [s[4]["graphed"] for s in rec.spans
               if s[0] == "env.batched_step"]
    if after_first is not None:
        del held
    return results, kept, graphed


def leaves(result):
    return core.leaves(result[0]) + list(result[1:])


def assert_equal_runs(got, want):
    """Every leaf of every call's results equal (results or kept
    copies)."""
    for g, w in zip(got, want, strict=True):
        g = g if isinstance(g, list) else leaves(g)
        w = w if isinstance(w, list) else leaves(w)
        for a, b in zip(g, w, strict=True):
            assert torch.equal(a, b)


def test_graphable_from_device_and_task():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert fast.batched_step_graphable(cuda, KIN)
    assert fast.batched_step_graphable(cuda, RGB)
    assert not fast.batched_step_graphable(cuda, NOISY)
    assert not fast.batched_step_graphable(cpu, KIN)


def test_launch_runs_at_once_outside_a_capture():
    ran = []
    graphs.launch(lambda: ran.append(1))
    assert ran == [1]


def test_constant_is_made_once_per_dtype():
    cpu = torch.device("cpu")
    a = graphs.constant((1.0, 2.0), torch.float32, cpu)
    assert a is graphs.constant((1.0, 2.0), torch.float32, cpu)
    assert torch.equal(a, torch.tensor([1.0, 2.0]))
    assert graphs.constant((1.0, 2.0), torch.float64, cpu).dtype \
        == torch.float64


@pytest.mark.parametrize("task", [KIN, NOISY], ids=["kin", "reset_noise"])
def test_graphed_reads_zero_on_eager_paths(task):
    graphed = rollout(DYN, task, 4, 3, "cpu")[2]
    assert graphed == [0, 0, 0]


def test_reset_noise_stays_eager_under_the_graph_rule(host_graph):
    graphed = rollout(DYN, NOISY, 4, 3, "cpu")[2]
    assert graphed == [0, 0, 0]


@pytest.mark.parametrize("task,envs", [(KIN, 8), (RGB, 3)],
                         ids=["kin", "rgb"])
def test_host_graph_equals_eager(task, envs, host_graph, monkeypatch):
    """The graphed path's bookkeeping against the eager body: equal
    results over an auto-reset, every call after the capture a replay
    (the reset state passed again at step 10 is copied in), and every
    returned tensor as it was when it was returned."""
    got, kept, graphed = rollout(DYN, task, envs, 12, "cpu", restart=10)
    monkeypatch.setattr(fast, "batched_step_graphable", lambda *a: False)
    want, _, eager = rollout(DYN, task, envs, 12, "cpu", restart=10)
    assert graphed == [0] + [1] * 11 and eager == [0] * 12
    assert any(bool(r[4].any()) for r in want)
    assert_equal_runs(got, want)
    assert_equal_runs(got, kept)


def test_host_graph_runs_other_layouts_eagerly(host_graph):
    """A state whose leaves are laid out otherwise than the step's results
    runs the eager step (the reductions follow the inputs' strides), with
    the same results as the state the graph holds."""
    reset_fn, step_fn = fast.make_batched_step(DYN, KIN, 4, device="cpu",
                                               obs_layout="flat")
    state, _ = reset_fn()
    action = torch.full((4, 1, 4), 0.3)
    with profiling.recording() as rec:
        state = step_fn(state, action)[0]
        moved = core.map_leaves(lambda x: x.t().contiguous().t()
                                if x.dim() > 1 else x, state)
        a = step_fn(moved, action)
        b = step_fn(state, action)
    assert [s[4]["graphed"] for s in rec.spans
            if s[0] == "env.batched_step"] == [0, 0, 1]
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)


CARD_PATHS = {
    # K1 and the render kernel at 64 cameras
    "rgb": lambda: (DYN, RGB, 64, True),
    # K1 with the kernel's obs12 rows
    "kin": lambda: (DYN, KIN, 256, True),
    # K5 with the embedded PID, the evaluation's form (no auto-reset)
    "routing_pyb": lambda: (*make_routing_config(num_drones=4), 64, False),
}


@pytest.mark.parametrize("path", list(CARD_PATHS))
def test_graphed_step_equals_eager_on_the_card(path, card, monkeypatch):
    """Twelve calls graphed against the same twelve through the eager
    body, from the reset on the same actions: every output and state leaf
    equal bit for bit, auto-resets included; every call after the capture
    a replay; each kernel launched, and counted by its wrapper, once a
    call on both paths."""
    cfg, task, envs, autoreset = CARD_PATHS[path]()
    launches = lambda: [m.launches for m in KERNELS]
    before = launches()
    got, _, graphed = rollout(cfg, task, envs, 12, card, autoreset)
    middle = launches()
    monkeypatch.setattr(fast, "batched_step_graphable", lambda *a: False)
    want, _, eager = rollout(cfg, task, envs, 12, card, autoreset)
    after = launches()
    assert graphed == [0] + [1] * 11 and eager == [0] * 12
    assert [m - b for m, b in zip(middle, before)] == [
        a - m for a, m in zip(after, middle)]
    assert 12 in [a - m for a, m in zip(after, middle)]
    if autoreset:
        assert any(bool(r[4].any()) for r in want)
    assert_equal_runs(got, want)


def test_returned_tensors_survive_later_steps_on_the_card(card):
    """The results of step t, as returned, equal their copies taken as
    the call returned, after steps t + 1 to t + 11 and another rollout (a
    replay writes its static tensors, never what it returned)."""
    got, kept, graphed = rollout(DYN, KIN, 256, 12, card)
    rollout(DYN, KIN, 256, 12, card)
    assert graphed == [0] + [1] * 11
    assert_equal_runs(got, kept)


def test_replays_survive_an_emptied_constant_cache_on_the_card(
        card, monkeypatch):
    """The constants the captured step reads (the hover target) stay the
    graph's after `graphs.constant`'s cache is emptied and their memory
    is asked for again: the replays equal the eager step."""
    def evict():
        graphs._constant.cache_clear()
        return [torch.full((3,), float("nan"), device=card)
                for _ in range(256)]
    got, _, graphed = rollout(DYN, KIN, 256, 12, card, after_first=evict)
    assert graphed == [0] + [1] * 11
    monkeypatch.setattr(fast, "batched_step_graphable", lambda *a: False)
    want, _, _ = rollout(DYN, KIN, 256, 12, card)
    assert_equal_runs(got, want)
