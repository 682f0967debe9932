"""Admissible decision replay: the float32 reference takes the discrete
choices of the run it is compared with (indices, masks, labels derived by
ranking or thresholding floats) wherever they are admissible under a
rounding band of its own floats, and makes its own choice where they are
not. Everything continuous (features, logits, boxes, IoUs, losses,
gradients, the update, the EMA) it computes itself.

With random weights the scores a ranking compares are near-equal, so one
bfloat16 rounding picks other boxes than float32 does; comparing losses
then compares two different sets of boxes. Replaying the compared run's
choices compares the arithmetic on the same boxes, as a language model's
logits are compared on the same tokens rather than its sampled tokens.

The band. A choice is admissible when the reference's own values could
have made it after a rounding of relative size EPS on the scores (of the
set's largest magnitude: a logit near zero carries the rounding of the
terms that made it, not of itself) and an absolute DELTA on IoUs:
  * a top-k or a threshold: no chosen value lies more than the band below
    the k-th value (or the threshold), no unchosen value more than the band
    above it, and the chosen order is descending within the band;
  * greedy NMS: no two kept boxes overlap above thr + DELTA, and every
    suppressed box overlaps above thr - DELTA a kept box whose score is at
    least its own less the band;
  * an IoU matcher: every label's bucket holds the best IoU within DELTA,
    every matched index is within DELTA of the best, and (low-quality
    matches) every promoted anchor is within DELTA of some gt's best and
    every gt's best has a promoted anchor within DELTA.
EPS and DELTA lie between 2^-8 (one bfloat16 rounding) and 2^-5 (half a
float8 e4m3 rounding), at the top: the bfloat16 program's scores, after
the network's depth, stray from float32 by 2^-7 to 2^-5 of a set's largest
magnitude, so a band of 2^-6 refuses nearly every RPN set of a sound run
(77 of 80 image-levels of a burn-in step on the H100) and 2^-5 only a few
(5 of 80), while the float8 control's choices are refused at every band
from 2^-8 to 2^-5 (192 of the 208 sets of that step). A set is one
image's (for the RPN's per-level choices, one image-level's), and a set
that is not admissible takes the reference's own choice whole.

The samplers' draws follow the proposals. The ROI sampler draws one number
a proposal slot, so a refused RPN set, whose proposals differ from the
compared run's in a few boxes, would otherwise hand every slot after the
first difference another draw and sample the image's 512 rois anew: on a
sound run of the H100 three such images of sixteen moved one leaf's first
gradient by 2.6%, over half as far as float8 moves it. `draw_slots` gives each of
the reference's proposals the draws of the same proposal (by anchor) in
the compared run's list, so a refusal changes the sample only in the
proposals that differ. The choices made on a list of proposals match the
compared run's by proposal too: the RPN's global top-k its picks by anchor,
across levels whose lists differ, and the box head's inference its
(proposal, class) candidates.

A refused set takes the reference's own choice, made in the order of
`guided_key`: its own values, near-ties within the band broken as the
compared run broke them. A greedy NMS or a top-k over near-equal scores
otherwise cascades: one decision beyond the band, and the reference's own
order then keeps hundreds of other boxes (on a sound run of the H100, a
seed whose 69 refused burn-in sets moved one FPN leaf's gradient 6.2%,
against 0.5% with every choice forced onto the program's).

`Choices` runs in two modes: without a program's records it makes its own
choices and records them; with them it replays. Either way it records the
choices it took, so the reference can replay its own run (which refuses
nothing and reads gaps of 0), and counts per step the sets taken from the
program and the sets refused."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from ..ops.boxes import pairwise_iou

EPS = 2.0 ** -5
DELTA = 2.0 ** -5
# elements of an (S, K, K) IoU block held at once
_BLOCK = 1 << 25


class Choices:
    """The discrete choices of a run's steps: program[i][kind] is the list of
    step i's records of that kind in call order (dicts of (B, ...) tensors),
    or None to choose alone."""

    def __init__(self, program: Optional[List[Dict[str, list]]] = None, eps: float = EPS, delta: float = DELTA):
        self.program = program
        self.eps, self.delta = eps, delta
        self.chosen: List[Dict[str, list]] = []
        self.taken: List[Dict[str, int]] = []
        self.refused: List[Dict[str, int]] = []
        self._next: Dict[str, int] = {}

    def start_step(self) -> None:
        self.chosen.append({})
        self.taken.append({})
        self.refused.append({})
        self._next = {}

    def program_record(self, kind: str, device) -> Optional[Dict[str, torch.Tensor]]:
        """The program's next record of `kind` in this step (None when not
        replaying)."""
        if self.program is None:
            return None
        step = len(self.chosen) - 1
        records = self.program[step].get(kind, []) if step < len(self.program) else []
        j = self._next.get(kind, 0)
        self._next[kind] = j + 1
        if j >= len(records):
            raise RuntimeError(f"step {step}: the program made {len(records)} {kind} choice(s), the reference more")
        return {k: v.to(device) if v.dtype == torch.bool or v.is_floating_point() else v.to(device).long()
                for k, v in records[j].items()}

    def take(self, kind: str, ok: torch.Tensor) -> torch.Tensor:
        """Count the sets where the program's choice of `kind` is taken
        (`ok`) and those refused; -> ok."""
        n_ok = int(ok.sum())
        self.taken[-1][kind] = self.taken[-1].get(kind, 0) + n_ok
        self.refused[-1][kind] = self.refused[-1].get(kind, 0) + ok.numel() - n_ok
        return ok

    @staticmethod
    def pick(ok: torch.Tensor, program: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        """The program's choice in the sets where `ok` (its leading dims), the
        reference's own elsewhere."""
        return torch.where(ok.reshape(ok.shape + (1,) * (own.dim() - ok.dim())), program, own)

    def merge(self, kind: str, ok: torch.Tensor, program: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
        """take, then pick."""
        return self.pick(self.take(kind, ok), program, own)

    def record(self, kind: str, **tensors: torch.Tensor) -> None:
        self.chosen[-1].setdefault(kind, []).append({k: v.detach().cpu() for k, v in tensors.items()})

    def counts(self) -> Dict[str, int]:
        """replay.step<i>.taken / .refused: the sets of each step."""
        out = {}
        for i, (t, r) in enumerate(zip(self.taken, self.refused)):
            out[f"replay.step{i}.taken"] = sum(t.values())
            out[f"replay.step{i}.refused"] = sum(r.values())
            for kind, n in sorted(r.items()):
                if n:
                    out[f"replay.step{i}.refused.{kind}"] = n
        return out


def _band(values: torch.Tensor, eligible: torch.Tensor, eps: float) -> torch.Tensor:
    """(S,) eps x the largest finite magnitude of each set's eligible values."""
    mag = torch.where(eligible & torch.isfinite(values), values.abs(), torch.zeros((), device=values.device))
    return eps * mag.amax(-1)


def ranked_ok(values: torch.Tensor, chosen: torch.Tensor, count: torch.Tensor, thresh: Optional[float],
              eps: float) -> torch.Tensor:
    """A top-k above an optional threshold. values (S, N), the reference's
    own, -inf where not eligible; chosen (S, k) the compared run's indices
    in rank order, of which the first `count` (S,) were chosen (the rest,
    where fewer than k passed the threshold, are not). -> (S,) bool."""
    s, k = chosen.shape
    n = values.shape[1]
    dev = values.device
    slot = torch.arange(k, device=dev)[None] < count[:, None]
    in_range = ((chosen >= 0) & (chosen < n)) | ~slot
    idx = chosen.clamp(0, max(n - 1, 0))
    neg = torch.full((), float("-inf"), device=dev)
    v = torch.where(slot, torch.gather(values, 1, idx), neg)
    band = _band(values, torch.isfinite(values), eps)[:, None]
    # descending within the band: no later pick above an earlier one by more
    later = v.flip(1).cummax(1).values.flip(1)
    ordered = (v >= later - band) | ~slot
    picks = torch.zeros((s, n), dtype=torch.long, device=dev).scatter_add_(1, idx, slot.long())
    low = torch.where(slot, v, torch.full((), float("inf"), device=dev)).amin(1, keepdim=True)
    if thresh is None:
        above = torch.ones_like(low, dtype=torch.bool)
        bound = torch.where(count[:, None] == k, low, neg)
    else:
        above = (low >= thresh - band) | (count[:, None] == 0)
        bound = torch.where(count[:, None] == k, low, torch.full((), float(thresh), device=dev))
    rest = torch.where(picks > 0, neg, values).amax(1, keepdim=True)
    return (in_range.all(1) & ordered.all(1) & (picks <= 1).all(1) & above[:, 0]
            & (rest <= bound + band)[:, 0])


def threshold_ok(values: torch.Tensor, eligible: torch.Tensor, chosen: torch.Tensor, thresh: float,
                 eps: float) -> torch.Tensor:
    """A mask of the eligible values above `thresh`. values, eligible,
    chosen (S, N) -> (S,) bool."""
    band = _band(values, eligible, eps)[:, None]
    inside = (chosen & ~eligible).any(1)
    low = (chosen & (values < thresh - band)).any(1)
    high = (eligible & ~chosen & (values > thresh + band)).any(1)
    return ~(inside | low | high)


def guided_key(values: torch.Tensor, rank: torch.Tensor, eps: float) -> torch.Tensor:
    """A ranking key (float64) of the reference's values (S, N), -inf where
    a value is -inf: the values in steps of the set's band, the near-ties
    within a step broken by the compared run's rank (S, N; lower first, -1
    for items it did not rank, which go last). Ordered by the key, two
    values change places only within one band, so a top-k or a greedy NMS
    taken in that order is admissible by the rules above; it differs from
    the compared run's choice only where that run strayed beyond the band.
    A refused set takes this choice: the reference's own, as near the
    compared run's as its own values allow."""
    n = values.shape[-1]
    v = values.double()
    band = _band(values, torch.isfinite(values), eps)[:, None].double().clamp(min=torch.finfo(torch.float64).tiny)
    step = torch.floor(torch.where(torch.isfinite(v), v, torch.zeros((), dtype=v.dtype, device=v.device)) / band)
    key = step * (n + 1) + (n - torch.where(rank >= 0, rank, n).double())
    return torch.where(torch.isfinite(v), key, torch.full((), float("-inf"), dtype=v.dtype, device=v.device))


def id_slots(ids: torch.Tensor, wanted: torch.Tensor, n_ids: int) -> torch.Tensor:
    """The slot of each wanted id in its row of `ids`. ids (B, S) and wanted
    (B, P) hold ids below n_ids, each at most once in a row of ids, and -1
    for an empty slot. -> (B, P), -1 where the id is absent or -1."""
    b, s = ids.shape
    inv = torch.full((b, n_ids + 1), -1, dtype=torch.long, device=ids.device)
    inv.scatter_(1, torch.where(ids >= 0, ids, n_ids), torch.arange(s, device=ids.device).expand(b, -1))
    inv[:, n_ids] = -1
    return torch.gather(inv, 1, torch.where(wanted >= 0, wanted, n_ids))


@dataclasses.dataclass
class ProposalSlots:
    """How the reference's proposal list lines up with the compared run's,
    proposal by proposal (by anchor): draws (B, P), the compared run's slot
    whose sampler draws each of the reference's slots takes (`draw_slots`);
    at (B, P), the reference's slot of each of the compared run's
    proposals, -1 where the reference has no such proposal."""

    draws: torch.Tensor
    at: torch.Tensor


def draw_slots(mine: torch.Tensor, theirs: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Which of the compared run's list slots lends its sampler draws to each
    of the reference's: a sampler draws one number a slot, so where a
    refused set leaves the reference's list of items (proposals, by anchor
    id) other than the compared run's, the draws follow the items. Each of
    the reference's slots takes the slot of the same item in the compared
    run's list; the slots left over on both sides pair up in order. mine,
    theirs (B, P) item ids below n_ids, -1 for an empty slot. -> (B, P), a
    permutation of each row, the identity where both lists agree."""
    b, p = mine.shape
    at = id_slots(theirs, mine, n_ids)
    matched = at >= 0
    used = torch.zeros((b, p), dtype=torch.long, device=mine.device)
    used = used.scatter_add_(1, at.clamp(min=0), matched.long()) > 0
    left = torch.sort(used.long(), dim=1, stable=True).indices
    rank = (torch.cumsum((~matched).long(), 1) - 1).clamp(min=0)
    return torch.where(matched, at, torch.gather(left, 1, rank))


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(S, K, 4), (S, L, 4) -> (S, K, L) IoU, 0 where the union is empty."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    rb = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, :, None] + area_b[:, None, :] - inter
    return torch.where(union > 0, inter / union.clamp(min=1e-12), torch.zeros((), device=a.device))


def nms_ok(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor, keep: torch.Tensor, thresh: float,
           eps: float, delta: float, classes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS (suppress IoU > thresh among one class). boxes (S, K, 4),
    scores, valid, keep (S, K) -> (S,) bool."""
    s, k = scores.shape
    out = []
    rows = max(1, _BLOCK // max(k * k, 1))
    eye = torch.eye(k, dtype=torch.bool, device=boxes.device)
    for a in range(0, s, rows):
        sl = slice(a, a + rows)
        b, sc, v, kp = boxes[sl], scores[sl], valid[sl], keep[sl]
        iou = _iou(b, b)
        if classes is not None:
            iou = torch.where(classes[sl][:, :, None] == classes[sl][:, None, :], iou, torch.zeros((), device=b.device))
        kept = kp & v
        band = _band(sc, v, eps)[:, None, None]
        apart = ~((iou > thresh + delta) & kept[:, :, None] & kept[:, None, :] & ~eye).any((1, 2))
        cover = (kept[:, :, None] & (iou > thresh - delta) & (sc[:, :, None] >= sc[:, None, :] - band)).any(1)
        covered = ~(v & ~kp & ~cover).any(1)
        out.append(~(kp & ~v).any(1) & apart & covered)
    return torch.cat(out) if out else torch.ones((0,), dtype=torch.bool, device=boxes.device)


def match_ok(gt_boxes: torch.Tensor, gt_mask: torch.Tensor, boxes: torch.Tensor, idx: torch.Tensor,
             labels: torch.Tensor, thresholds, label_values, allow_low_quality: bool, delta: float) -> torch.Tensor:
    """An IoU matcher's (idx, labels) over `boxes` (A, 4) or (B, A, 4)
    against gt (B, M); idx, labels (B, A). -> (B,) bool."""
    out = []
    lows = [float("-inf")] + list(thresholds)
    highs = list(thresholds) + [float("inf")]
    for i in range(gt_boxes.shape[0]):
        g = gt_boxes[i][gt_mask[i]]
        slots = torch.nonzero(gt_mask[i])[:, 0]
        lab = labels[i].long()
        if g.shape[0] == 0:
            out.append(bool((lab == label_values[0]).all()))
            continue
        q = pairwise_iou(g, boxes if boxes.dim() == 2 else boxes[i])  # (G, A)
        best = q.amax(0)
        ok = torch.zeros_like(lab, dtype=torch.bool)
        for value, lo, hi in zip(label_values, lows, highs):
            ok |= (lab == value) & (best >= lo - delta) & (best < hi + delta)
        cover_ok = True
        if allow_low_quality:
            top = q.amax(1, keepdim=True)
            near = (q >= top - delta) & (top + delta > 0)
            ok |= (lab == label_values[-1]) & near.any(0)
            promoted = near & (lab == label_values[-1])[None]
            cover_ok = bool((promoted.any(1) | (top[:, 0] <= delta)).all())
        # the matched slot, as an index among the valid ones
        pos = torch.searchsorted(slots, idx[i].long())
        hit = (pos < slots.numel()) & (slots[pos.clamp(max=slots.numel() - 1)] == idx[i].long())
        q_idx = torch.gather(q, 0, pos.clamp(max=slots.numel() - 1)[None])[0]
        idx_ok = hit & (q_idx >= best - delta)
        out.append(bool(ok.all()) and bool(idx_ok.all()) and cover_ok)
    return torch.tensor(out, dtype=torch.bool, device=gt_boxes.device)
