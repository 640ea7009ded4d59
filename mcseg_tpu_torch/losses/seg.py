"""Segmentation losses: 2-D cross-entropy with an ignore label, and the
multitask trainer's auxiliary losses.

The port of the JAX package's ``losses/seg.py``. Logits are NCHW, so the
class axis is 1. In ``cross_entropy_2d`` ignored pixels add nothing to the
sum and are left out of the count; the sum is divided by ``max(n_valid,
1)``, so a batch with every pixel ignored gives 0 (``reduction="mean"``
would give NaN there). The auxiliary heads' losses: ``balanced_bce_2d``
(boundary detection against ``boundary_targets_from_labels``) and
``berhu_loss`` (depth regression).

Every loss takes ``dp``, a data-parallel context (``parallel.mesh``): its
sums, counts and berHu's max are then taken over the group's global batch
(``all_sum``, ``all_max``), so every rank gets the loss of the global
batch, as GSPMD computes it in the JAX package. Without one (None) the
loss is that of the local batch, computed as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mcseg_tpu_torch.parallel.mesh import DataParallel, all_max, all_sum

IGNORE_INDEX = 255


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> float32 for the loss math; float64 oracles stay float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = IGNORE_INDEX,
                     dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Mean cross-entropy over the valid pixels of ``logits`` [B,C,H,W]
    against integer ``labels`` [B,H,W]."""
    logits = at_least_f32(logits)
    labels = labels.long()
    nll = all_sum(F.cross_entropy(logits, labels, ignore_index=ignore_index,
                                  reduction="sum"), dp)
    n_valid = all_sum((labels != ignore_index).sum(), dp).clamp(min=1)
    return nll / n_valid.to(logits.dtype)


def boundary_targets_from_labels(labels: torch.Tensor, ignore_index: int = IGNORE_INDEX
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Semantic-boundary targets from a label map [B,H,W]: a pixel is a
    boundary pixel iff a 4-neighbour carries a different valid class (both
    sides of an edge are marked; an edge against an ignore pixel is none).
    Returns (targets float32 {0, 1} [B,H,W], valid bool [B,H,W])."""
    valid = labels != ignore_index
    edge_v = (labels[:, 1:] != labels[:, :-1]) & valid[:, 1:] & valid[:, :-1]
    edge_h = (labels[:, :, 1:] != labels[:, :, :-1]) & valid[:, :, 1:] & valid[:, :, :-1]
    boundary = torch.zeros_like(valid)
    boundary[:, 1:] |= edge_v
    boundary[:, :-1] |= edge_v
    boundary[:, :, 1:] |= edge_h
    boundary[:, :, :-1] |= edge_h
    return boundary.to(torch.float32), valid


def balanced_bce_2d(logits: torch.Tensor, targets: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Class-balanced binary cross-entropy (HED): over the valid pixels,
    boundary pixels weigh ``1 - beta`` and the rest ``beta``, with ``beta``
    the boundary fraction. ``logits`` [B,1,H,W] or [B,H,W], ``targets``
    {0, 1} [B,H,W]. The weights are computed in the logits' dtype."""
    if logits.dim() == targets.dim() + 1:
        logits = logits[:, 0]
    logits = at_least_f32(logits)
    targets = targets.to(logits.dtype)
    if valid_mask is None:
        valid_mask = torch.ones_like(targets, dtype=torch.bool)
    validf = valid_mask.to(logits.dtype)
    beta = all_sum((targets * validf).sum(), dp) / all_sum(validf.sum(), dp).clamp(min=1.0)
    w = torch.where(targets > 0.5, 1.0 - beta, beta) * validf
    # the stable form: max(x, 0) - x t + log(1 + exp(-|x|))
    bce = logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return all_sum((w * bce).sum(), dp) / all_sum(w.sum(), dp).clamp(min=1e-6)


def berhu_loss(pred: torch.Tensor, target: torch.Tensor,
               valid_mask: Optional[torch.Tensor] = None,
               dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Reverse-Huber loss of ``pred`` [B,1,H,W] against depth ``target``
    [B,H,W] or [B,1,H,W]: |e| up to c, (e^2 + c^2) / 2c beyond, with c =
    max|e| / 5 over the valid pixels (at least 1e-6), summed over the pixels
    and divided by max(n_valid, 1). Invalid pixels (not finite, or <= 0) are
    zeroed before the max. The gradient flows through c, as in the JAX
    package, whose max is not stopped either."""
    if target.dim() == pred.dim() - 1:
        target = target[:, None]
    if valid_mask is None:
        valid_mask = torch.isfinite(target) & (target > 0)
    err = torch.where(valid_mask, pred - target, torch.zeros((), dtype=pred.dtype))
    abs_err = err.abs()
    c = (all_max(abs_err.amax(), dp) / 5.0).clamp(min=1e-6)
    loss = torch.where(abs_err <= c, abs_err, (err * err + c * c) / (2.0 * c))
    return (all_sum(loss.sum(), dp)
            / all_sum(valid_mask.sum(), dp).clamp(min=1).to(loss.dtype))
