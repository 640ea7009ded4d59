"""Classifier-discrepancy distances for MCD (NCHW logits, classes on axis 1).

The port of the JAX package's ``losses/discrepancy.py``: 'diff' is the mean
absolute difference of the two classifiers' softmax outputs over all
pixels and classes (MCD, arXiv:1712.02560, eq. 2); 'symkl' the symmetric KL
averaged over pixels. Both compute in at least float32. Under a
data-parallel context ``dp`` the means are over the group's global batch
(``parallel.mesh.all_sum``; every rank holds a batch of the same shape).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from mcseg_tpu_torch.losses.seg import at_least_f32
from mcseg_tpu_torch.parallel.mesh import DataParallel, all_sum, world_size


def _global_mean(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    if dp is None:
        return x.mean()
    return all_sum(x.sum(), dp) / (x.numel() * world_size(dp))


def discrepancy_diff(logits1: torch.Tensor, logits2: torch.Tensor,
                     dp: Optional[DataParallel] = None) -> torch.Tensor:
    """mean |softmax(o1) - softmax(o2)| over B*H*W*C."""
    p1 = torch.softmax(at_least_f32(logits1), dim=1)
    p2 = torch.softmax(at_least_f32(logits2), dim=1)
    return _global_mean((p1 - p2).abs(), dp)


def discrepancy_symkl(logits1: torch.Tensor, logits2: torch.Tensor,
                      dp: Optional[DataParallel] = None) -> torch.Tensor:
    """(KL(p1||p2) + KL(p2||p1)) / 2, mean over pixels."""
    lp1 = torch.log_softmax(at_least_f32(logits1), dim=1)
    lp2 = torch.log_softmax(at_least_f32(logits2), dim=1)
    kl12 = (lp1.exp() * (lp1 - lp2)).sum(dim=1)
    kl21 = (lp2.exp() * (lp2 - lp1)).sum(dim=1)
    return _global_mean(0.5 * (kl12 + kl21), dp)


def get_prob_distance_criterion(name: str, dp: Optional[DataParallel] = None
                                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``d(logits1, logits2)`` by name, over ``dp``'s global batch when given."""
    if name == "diff":
        return functools.partial(discrepancy_diff, dp=dp)
    if name in ("symkl", "sym_kl"):
        return functools.partial(discrepancy_symkl, dp=dp)
    raise ValueError(f"unknown discrepancy criterion {name!r} (options: diff, symkl)")
