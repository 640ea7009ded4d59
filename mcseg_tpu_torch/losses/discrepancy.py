"""Classifier-discrepancy distances for MCD (NCHW logits, classes on axis 1).

The port of the JAX package's ``losses/discrepancy.py``: 'diff' is the mean
absolute difference of the two classifiers' softmax outputs over all
pixels and classes (MCD, arXiv:1712.02560, eq. 2); 'symkl' the symmetric KL
averaged over pixels. Both compute in at least float32.
"""

from __future__ import annotations

from typing import Callable

import torch

from mcseg_tpu_torch.losses.seg import at_least_f32


def discrepancy_diff(logits1: torch.Tensor, logits2: torch.Tensor) -> torch.Tensor:
    """mean |softmax(o1) - softmax(o2)| over B*H*W*C."""
    p1 = torch.softmax(at_least_f32(logits1), dim=1)
    p2 = torch.softmax(at_least_f32(logits2), dim=1)
    return (p1 - p2).abs().mean()


def discrepancy_symkl(logits1: torch.Tensor, logits2: torch.Tensor) -> torch.Tensor:
    """(KL(p1||p2) + KL(p2||p1)) / 2, mean over pixels."""
    lp1 = torch.log_softmax(at_least_f32(logits1), dim=1)
    lp2 = torch.log_softmax(at_least_f32(logits2), dim=1)
    kl12 = (lp1.exp() * (lp1 - lp2)).sum(dim=1)
    kl21 = (lp2.exp() * (lp2 - lp1)).sum(dim=1)
    return (0.5 * (kl12 + kl21)).mean()


def get_prob_distance_criterion(name: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if name == "diff":
        return discrepancy_diff
    if name in ("symkl", "sym_kl"):
        return discrepancy_symkl
    raise ValueError(f"unknown discrepancy criterion {name!r} (options: diff, symkl)")
