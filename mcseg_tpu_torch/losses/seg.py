"""Segmentation loss: 2-D cross-entropy with an ignore label.

The port of the JAX package's ``losses/seg.py`` ``at_least_f32`` and
``cross_entropy_2d``. Logits are NCHW, so the class axis is 1. Ignored
pixels add nothing to the sum and are left out of the count; the sum is
divided by ``max(n_valid, 1)``, so a batch with every pixel ignored gives 0
(``reduction="mean"`` would give NaN there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IGNORE_INDEX = 255


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16/f16 -> float32 for the loss math; float64 oracles stay float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy_2d(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean cross-entropy over the valid pixels of ``logits`` [B,C,H,W]
    against integer ``labels`` [B,H,W]."""
    logits = at_least_f32(logits)
    labels = labels.long()
    nll = F.cross_entropy(logits, labels, ignore_index=ignore_index,
                          reduction="sum")
    n_valid = (labels != ignore_index).sum().clamp(min=1)
    return nll / n_valid.to(logits.dtype)
