"""The numbers that decide ``correct``, each held against its limit.

A cell's limits file (``benchmark/limits/<cell>.json``) names the numbers it
compares; the others are printed beside them in every run.

Training (the program's first iterations against the reference's from the
same weights, raw planes and draws):

  input_gap      the preprocessed inputs that the MCD step received (HHA,
                 crops and flips, the normalize kernel's stack), source and
                 target of every check iteration: the largest ‖p - r‖ / ‖r‖
                 of a stack; ``hha_gap`` the same over the HHA planes alone;
  label_mismatch the share of the source labels' pixels that differ;
  loss_gap       the largest relative gap |p - r| / |r| of the losses the
                 iterations return (A's, B's and the last C's of each);
                 ``loss_a_gap`` of the first iteration's step A alone;
  grad_gap       the first gradient, leaf by leaf: the gap between the
                 norms of the program's and the reference's gradient of a
                 leaf, over the larger of the reference's norm of that leaf
                 and its median leaf's norm. The program's gradient is worked
                 out from its optimizer's state after step A of the first
                 iteration: momentum buffer - weight decay x initial weight;
  grad_diff      the same leaves' differences ‖p - r‖ over the same norm;
  stats_a_diff   G's BatchNorm running statistics after step A of the first
                 iteration, whose one forward they average over every
                 pixel of the batch: the difference of their change,
                 leaf by leaf, over the same norm;
  update1_gap    the change of every leaf after the first iteration
                 (parameters and BatchNorm's running statistics), by the
                 gap of norms; ``update_gap`` after the last check
                 iteration. Parameters whose reference gradient is under a
                 thousandth of the median leaf's move by round-off alone and
                 are left out (``moving_leaves``).

Each leaf-by-leaf number is given by its worst leaf (the name alone), its
90th percentile (``_q90``) and its median leaf (``_median``).

Serving (a sample of the window's answers against the reference's logits
of the same raw planes):

  logit_gap      the widest gap by which the reference's logit of the
                 served class lies below its largest logit at that pixel;
  tile_gap       the mean of the gap over each 8x8 tile of a class map,
                 widest: a wrong region shows there, where a near tie that
                 rounding flips at a scattered pixel does not;
  class_mismatch the share of pixels whose served class is not the
                 reference's best.

A number that cannot be formed (shapes that differ, a value that is not
finite) is infinite, and fails any limit.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

INF = math.inf
TILE = 8  # pixels a side; a 16x16 block anywhere covers at least one whole tile


def loss_gap(prog: Sequence, ref: Sequence) -> float:
    """Over lists of loss dicts (or of floats)."""
    def flat(xs):
        return [v for x in xs for v in (x.values() if isinstance(x, dict) else [x])]

    p, r = flat(prog), flat(ref)
    if len(p) != len(r):
        return INF
    gaps = [abs(a - b) / abs(b) for a, b in zip(p, r)]
    return max(gaps) if all(map(math.isfinite, gaps)) else INF


def _rel(p: torch.Tensor, r: torch.Tensor) -> float:
    if p.shape != r.shape:
        return INF
    r = r.double()
    v = float((p.double() - r).norm() / r.norm().clamp_min(1e-30))
    return v if math.isfinite(v) else INF


def input_numbers(prog: List[Tuple], ref: List[Tuple], input_ch: int) -> Dict[str, float]:
    """``input_gap``, ``hha_gap`` (where the input has HHA planes) and
    ``label_mismatch`` over the check iterations' (xs, ys, xt)."""
    if len(prog) != len(ref):
        return {"input_gap": INF, "hha_gap": INF, "label_mismatch": INF}
    gaps, hha, mism = [0.0], [0.0], [0.0]
    for (pxs, pys, pxt), (rxs, rys, rxt) in zip(prog, ref):
        for p, r in ((pxs, rxs), (pxt, rxt)):
            gaps.append(_rel(p, r))
            if input_ch == 6:
                hha.append(_rel(p[:, 3:], r[:, 3:]) if p.shape == r.shape else INF)
        mism.append(float((pys.long() != rys.long()).double().mean())
                    if pys.shape == rys.shape else INF)
    out = {"input_gap": max(gaps), "label_mismatch": max(mism)}
    if input_ch == 6:
        out["hha_gap"] = max(hha)
    return out


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def _median(values) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keys: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap of norms |‖p‖ - ‖r‖| over max(‖r‖, the median
    leaf's ‖r‖)."""
    keys = list(keys)
    if any(k not in prog for k in keys):
        return {k: INF for k in keys}
    p, r = norms({k: prog[k] for k in keys}), norms({k: ref[k] for k in keys})
    median = _median(r.values())
    return {k: abs(p[k] - r[k]) / max(r[k], median) for k in keys}


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keys: Iterable[str]) -> Dict[str, float]:
    """Each leaf's difference ‖p - r‖ over max(‖r‖, the median leaf's ‖r‖)."""
    keys = list(keys)
    if any(k not in prog or prog[k].shape != ref[k].shape for k in keys):
        return {k: INF for k in keys}
    r = norms({k: ref[k] for k in keys})
    d = norms({k: prog[k].double() - ref[k].double() for k in keys})
    median = _median(r.values())
    return {k: d[k] / max(r[k], median) for k in keys}


def summary(name: str, per_leaf: Dict[str, float]) -> Dict[str, float]:
    """``name`` (the worst leaf), ``name_q90`` (the 90th percentile of the
    leaves, nearest rank) and ``name_median``; infinite where a leaf's
    number is not finite."""
    values = sorted(per_leaf.values())
    if not values or not all(map(math.isfinite, values)):
        return {name: INF, f"{name}_q90": INF, f"{name}_median": INF}
    q90 = values[min(len(values) - 1, math.ceil(0.9 * len(values)) - 1)]
    return {name: values[-1], f"{name}_q90": q90, f"{name}_median": values[len(values) // 2]}


def moving_leaves(ref_grads: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    n = norms(ref_grads)
    median = _median(n.values())
    return [k for k, v in n.items() if v >= share * median]


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor):
    """Per pixel [B, H, W], how far the reference's logit of the served class
    lies below its largest logit (ref_logits [B, C, H, W], served class ids
    [B, H, W]); None where the answer has another shape or a class id out
    of range."""
    if served.shape != ref_logits.shape[:1] + ref_logits.shape[2:]:
        return None
    served = served.long()
    if bool(((served < 0) | (served >= ref_logits.shape[1])).any()):
        return None
    return ref_logits.amax(1) - ref_logits.gather(1, served[:, None])[:, 0]


def logit_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    gaps = served_gaps(ref_logits, served)
    return INF if gaps is None else float(gaps.max())


def tile_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest mean gap over a TILE x TILE tile of a class map (tiles on
    a grid from the top-left corner, the last row and column of tiles cut
    where the map is not a multiple of TILE)."""
    gaps = served_gaps(ref_logits, served)
    if gaps is None:
        return INF
    return float(torch.nn.functional.avg_pool2d(gaps[:, None].double(), TILE,
                                                ceil_mode=True).max())


def class_mismatch(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    if served.shape != ref_logits.shape[:1] + ref_logits.shape[2:]:
        return INF
    return float((ref_logits.argmax(1) != served.long()).double().mean())


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a limit whose number is missing is not correct."""
    table = {k: {"value": numbers.get(k), "limit": v} for k, v in sorted(limits.items())}
    ok = all(v["value"] is not None and v["limit"] is not None and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
