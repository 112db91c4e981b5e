"""The numbers that decide `correct`, each against its limit.

Rollout cells compare the program's env steps with the plain reference's
(`reference/ref_env.py`) on the same carry and actions:

- `outs_err`: the largest error of an observation or reward row, as
  |program - reference| / (1 + |reference|), over the envs whose flags
  agree and whose nearest-neighbour observation is not at a tie (two
  neighbours within 1e-5 of each other in squared distance: there the
  choice is decided by rounding);
- `carry_err`: the same over the carry rows the step writes (state,
  last rpm, PID rows, the ring, the step counter);
- `flag_share`: the largest share, over the compared steps, of envs whose
  terminated or truncated flag differs (a flag may flip only at a tie;
  such an env then resets on one side only, so it is left out of the two
  errors above from that step on).

Training cells compare the program's checked updates with the plain
reference's (`reference/ppo.py`): the first three from the same weights
and draws, and one update of the window, drawn from the seed, which the
reference repeats from the program's state before it (weights, Adam's
moments, the env carry and observations) on the same draws:

- `loss_gap`: the largest relative gap of an update's loss, pg_loss +
  vf_coef * v_loss - ent_coef * entropy (each the mean over the update's
  minibatch steps), over the four updates;
- `grad_gap`: the gradient as the optimizer got it, read from Adam's
  first moment after the first update (and after the window update):
  per parameter tensor the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that tensor
  and of the median tensor; the worst;
- `change_gap`: the same for the parameters' change over the first three
  updates (and over the window update), leaving out a tensor whose
  reference gradient (first moment) is under a thousandth of the median
  tensor's: it moves by round-off alone;
- `policy_gap`: every forward pass of the policy that the checked updates
  made (the rollout's, each minibatch step's), on rows of its own input
  at its own weights, as the program computed it against the reference's
  forward pass of the same rows and weights: the largest gap of the
  Gaussian mean or the value over the largest |reference| of that output
  in that call.  No env step lies between the two sides here, so an env
  at a flag tie cannot move it (the three numbers above carry that
  noise: an env whose done flag flips at a tie resets on one side only,
  and the two sides then train on other samples).
"""
from __future__ import annotations

import math

import torch


def row_err(prog: torch.Tensor, ref: torch.Tensor, keep) -> float:
    """max |prog - ref| / (1 + |ref|) over the columns `keep`; NaN counts
    as infinite."""
    if keep is not None:
        prog, ref = prog[:, keep], ref[:, keep]
    if prog.numel() == 0:
        return 0.0
    err = (prog.double() - ref.double()).abs() / (1.0 + ref.double().abs())
    err = torch.nan_to_num(err, nan=math.inf)
    return float(err.max())


class RolloutCompare:
    """Accumulates the rollout numbers over compared steps; `alive` tracks
    the free-running envs whose flags have agreed so far."""

    def __init__(self, ro: int):
        self.ro = ro
        self.outs_err = self.carry_err = self.flag_share = 0.0

    def step(self, prog_carry, prog_outs, ref_carry, ref_outs, alive=None,
             ties=None):
        """Compare one step; returns the envs whose flags agree (and were
        alive).  `ties`: envs left out of `outs_err`."""
        ro = self.ro
        pf = prog_outs[ro + 1:ro + 3] > 0.5
        rf = ref_outs[ro + 1:ro + 3] > 0.5
        same = (pf == rf).all(dim=0)
        if alive is not None:
            differ = (~same & alive).float().sum() / alive.float().sum() \
                .clamp(min=1.0)
            same = same & alive
        else:
            differ = (~same).float().mean()
        self.flag_share = max(self.flag_share, float(differ))
        self.outs_err = max(self.outs_err,
                            row_err(prog_outs[:ro + 1], ref_outs[:ro + 1],
                                    same if ties is None else same & ~ties))
        self.carry_err = max(self.carry_err,
                             row_err(prog_carry, ref_carry, same))
        return same

    def numbers(self) -> dict:
        return {"outs_err": self.outs_err, "carry_err": self.carry_err,
                "flag_share": self.flag_share}


def total_loss(m: dict, ppo: dict) -> float:
    return m["pg_loss"] + ppo["vf_coef"] * m["v_loss"] \
        - ppo["ent_coef"] * m["entropy"]


def leaf_gap_map(prog: dict, ref: dict, leave_out=()) -> dict:
    """Per tensor, | |prog| - |ref| | over max(|ref|, the median tensor's
    |ref|), norms of whole tensors."""
    names = [k for k in ref if k not in leave_out]
    pn = {k: float(torch.linalg.vector_norm(prog[k].double()))
          for k in names}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double()))
          for k in names}
    med = sorted(rn.values())[len(rn) // 2]
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in names}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def leaf_gaps(prog: dict, ref: dict, leave_out=()) -> float:
    """The worst tensor's gap (`leaf_gap_map`)."""
    return max(leaf_gap_map(prog, ref, leave_out).values())


def loss_gaps(prog: dict, ref: dict, ppo: dict) -> list:
    """Each update's relative gap of the loss."""
    out = []
    for mp, mr in zip(prog["metrics"], ref["metrics"]):
        lp, lr = total_loss(mp, ppo), total_loss(mr, ppo)
        gap = abs(lp - lr) / abs(lr)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def policy_gap(calls: list, num_hidden: int, device) -> float:
    """The largest gap (`policy_gap` above) over the kept calls, each a
    dict of `weights`, input rows `obs`, and the program's `mean` and
    `value` on them; the reference computes in float32 with TF32 off."""
    from portbench.reference.ppo import forward
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    try:
        with torch.no_grad():
            for c in calls:
                w = {k: v.to(device).float() for k, v in c["weights"].items()}
                mean, _, value = forward(w, c["obs"].to(device).float(),
                                         num_hidden)
                for p, r in ((c["mean"], mean), (c["value"], value)):
                    r = r.double()
                    gap = float((p.to(device).double() - r).abs().max()
                                / r.abs().max())
                    worst = max(worst, gap if math.isfinite(gap)
                                else math.inf)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return worst


def quiet_leaves(mu: dict) -> list:
    """Tensors whose reference gradient (first moment) is under a
    thousandth of the median tensor's."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in mu.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k, v in norms.items() if v < 1e-3 * med]


def train_numbers(prog: dict, ref: dict, ppo: dict, ref_window=None,
                  num_hidden=None, device="cpu") -> dict:
    """`prog` and `ref`: {"metrics": [a dict an update], "mu1": {name:
    tensor}, "change": {name: tensor}}; `prog` may hold `window` (the kept
    window update: its "metrics", "change", "mu_after"), compared with
    `ref_window`, and `calls` (the kept policy calls), which give
    `policy_gap`."""
    loss = loss_gaps(prog, ref, ppo)
    grad = [leaf_gaps(prog["mu1"], ref["mu1"])]
    change = [leaf_gaps(prog["change"], ref["change"],
                        quiet_leaves(ref["mu1"]))]
    if ref_window is not None:
        win = prog["window"]
        loss += loss_gaps({"metrics": [win["metrics"]]},
                          {"metrics": [ref_window["metrics"]]}, ppo)
        grad.append(leaf_gaps(win["mu_after"], ref_window["mu_after"]))
        change.append(leaf_gaps(win["change"], ref_window["change"],
                                quiet_leaves(ref_window["mu_after"])))
    out = {"loss_gap": max(loss), "grad_gap": max(grad),
           "change_gap": max(change)}
    if "calls" in prog:
        out["policy_gap"] = policy_gap(prog["calls"], num_hidden, device) \
            if prog["calls"] else math.inf
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a NaN, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
