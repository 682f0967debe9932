"""The correctness comparison of a train cell: the program's first steps
against the plain reference's from the same weights, batches and draws.

These numbers; a cell's `limits/<workload>.json` names the ones it holds to
a limit, and the others are printed beside them:
  first_loss_gap  |program - reference| / |reference| of the first step's
              total loss (the burn-in step). The later steps' losses are
              printed beside it but not compared: their pseudo labels come
              from the teacher's NMS over near-equal scores (the init's bias
              trick), where a rounding picks other boxes, so they swing from
              seed to seed on sound runs as much as on the control;
  grad_gap    the worst leaf's |norm(program) - norm(reference)| of the first
              step's gradient as the optimizer got it (its momentum buffer
              after one step, less the weight decay of the initial weights),
              over the larger of that leaf's reference norm and the median
              leaf's;
  change_gap  the same of each student leaf's change over the compared
              steps;
  teacher_gap the same of each EMA teacher leaf's change over the compared
              steps (the boundary's copy of the student, then the EMA): a
              teacher left where it started reads about 1;
  <number>.median  the median leaf's of the same gaps;
  first_loss_gap.<term>  each loss term of the first step on its own.
Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone, as a bias under a normalisation) are left out of
change_gap and teacher_gap by that rule, not by name."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

SMALL_LEAF = 1e-3


@torch.no_grad()
def first_gradient_norms(state, names: Dict[int, str], w0: Dict[str, torch.Tensor]):
    """{name: norm} of each trained leaf's first gradient, from SGD's
    momentum buffer after one step (the buffer is grad + wd * w0 then).
    Returns device tensors; the caller fetches them once."""
    out = {}
    for group in state.optimizer.sgd.param_groups:
        wd = group["weight_decay"]
        for p in group["params"]:
            buf = state.optimizer.sgd.state.get(p, {}).get("momentum_buffer")
            name = names[id(p)]
            if buf is None:  # no update reached the optimizer's state
                out[name] = torch.zeros((), dtype=torch.float64, device=p.device)
            else:
                out[name] = torch.linalg.vector_norm((buf - wd * w0[name]).double())
    return out


@torch.no_grad()
def change_norms(model, w0: Dict[str, torch.Tensor], names=None):
    """{name: norm of its change from w0} of the model's trained leaves, or
    of the leaves in `names` (the teacher trains none of its own)."""
    return {name: torch.linalg.vector_norm((p.detach() - w0[name]).double())
            for name, p in model.named_parameters() if (p.requires_grad if names is None else name in names)}


def to_host(norms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    if not norms:
        return {}
    names = list(norms)
    values = torch.stack([norms[n] for n in names]).cpu().tolist()
    return dict(zip(names, values))


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> List[float]:
    """Each kept leaf's |norm(program) - norm(reference)| over the larger of
    its reference norm and the median leaf's."""
    median = statistics.median(ref[n] for n in keep)
    return [abs(prog[n] - ref[n]) / max(ref[n], median) for n in keep]


def _worst_and_median(prog, ref, keep) -> tuple:
    if not keep:
        return math.inf, math.inf
    gaps = _leaf_gaps(prog, ref, keep)
    if any(not math.isfinite(g) for g in gaps):
        return math.inf, math.inf
    return max(gaps), statistics.median(gaps)


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{first_loss_gap, grad_gap, change_gap, teacher_gap, ...} of the
    program's readings against the reference's. Each side: {"losses":
    [...], "grad": {name: norm}, "change": {name: norm}, "teacher": {name:
    norm}}."""
    if not prog["losses"]:
        loss_gap = math.inf
    else:
        loss_gap = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-12)
        if not math.isfinite(loss_gap):
            loss_gap = math.inf
    out = {"first_loss_gap": loss_gap}
    if any(sorted(prog[k]) != sorted(ref[k]) for k in ("grad", "change", "teacher")):
        for k in ("grad_gap", "change_gap", "teacher_gap"):
            out[k] = out[f"{k}.median"] = math.inf
        return dict(out, **_term_gaps(prog, ref))
    median_grad = statistics.median(ref["grad"].values())
    moved = [k for k in sorted(ref["change"]) if ref["grad"].get(k, 0.0) >= SMALL_LEAF * median_grad]
    for key, leaves in (("grad", sorted(ref["grad"])), ("change", moved), ("teacher", moved)):
        out[f"{key}_gap"], out[f"{key}_gap.median"] = _worst_and_median(prog[key], ref[key], leaves)
    return dict(out, **_term_gaps(prog, ref))


def _term_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """first_loss_gap.<term>: each loss term of the first step on its own."""
    out = {}
    for k, r in ref.get("first_losses", {}).items():
        p = prog.get("first_losses", {}).get(k, math.nan)
        gap = abs(p - r) / max(abs(r), 1e-12)
        out[f"first_loss_gap.{k}"] = gap if math.isfinite(gap) else math.inf
    return out


def step_gaps(prog: Dict, ref: Dict) -> Dict[str, object]:
    """Each step's loss gap on its own and the worst leaves' names (printed
    beside the compared numbers, not held to a limit)."""
    out: Dict[str, object] = {f"loss_gap.step{i}": abs(p - r) / max(abs(r), 1e-12)
                              for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"]))}
    for key in ("grad", "change", "teacher"):
        names = [n for n in ref[key] if n in prog[key]]
        if names:
            median = statistics.median(ref[key][n] for n in names)
            out[f"worst_leaf.{key}"] = max(names, key=lambda n: abs(prog[key][n] - ref[key][n]) / max(ref[key][n], median))
    return out


def judge(numbers: Dict[str, float], limits: Dict) -> bool:
    """Every number the cell's limits file names is finite and within its
    limit (the file chooses the cell's compared numbers)."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= lim["limit"] for k, lim in limits.items())


def lines(numbers: Dict[str, float], limits: Dict) -> List[str]:
    return [f"{k} {numbers[k]!r} limit {lim['limit']!r}" for k, lim in limits.items()]


def checks(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict[str, float]]:
    return {k: {"value": numbers[k] if math.isfinite(numbers[k]) else str(numbers[k]), "limit": lim["limit"]}
            for k, lim in limits.items()}


def uncompared(numbers: Dict[str, float], limits: Dict) -> Dict[str, float]:
    return {k: v for k, v in numbers.items() if k not in limits}
