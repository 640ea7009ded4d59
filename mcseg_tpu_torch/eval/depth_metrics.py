"""Depth metrics of the multitask trainer's depth head: RMSE, absolute
relative error and delta < 1.25 accuracy, accumulated over batches as
valid-pixel sums.

The port of the JAX package's ``eval/depth_metrics.py``
(``depth_metric_sums``, ``finalize_depth_metrics``). A target pixel is
valid when finite and above ``min_depth``; a non-positive prediction is a
delta miss.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _delta_ratio(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """max(p/t, t/p), infinite where p <= 0 (t > 0 on valid pixels): for a
    negative prediction both ratios are negative, and the plain max would
    count a grossly wrong pixel as accurate."""
    return torch.where(p > 0, torch.maximum(p / t, t / p), torch.full_like(p, math.inf))


def depth_metric_sums(pred: torch.Tensor, target: torch.Tensor,
                      min_depth: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Valid-pixel sums of one batch (``pred`` [B,1,H,W] or [B,H,W],
    ``target`` [B,H,W]): n, squared errors, absolute relative errors and
    delta < 1.25 hits, as tensors on the device."""
    if pred.dim() == target.dim() + 1:
        pred = pred[:, 0]
    valid = torch.isfinite(target) & (target > min_depth)
    p = torch.where(valid, pred, torch.ones_like(pred))
    t = torch.where(valid, target, torch.ones_like(target)).to(p.dtype)
    err = torch.where(valid, p - t, torch.zeros_like(p))
    zero = torch.zeros_like(p)
    return {
        "n": valid.sum().to(torch.float32),
        "sse": (err ** 2).sum(),
        "sabs_rel": torch.where(valid, err.abs() / t, zero).sum(),
        "sdelta": (valid & (_delta_ratio(p, t) < 1.25)).sum().to(torch.float32),
    }


def finalize_depth_metrics(sums: Dict[str, float]) -> Dict[str, float]:
    """Summed batches -> {'rmse', 'abs_rel', 'delta_1.25'}."""
    n = max(float(sums["n"]), 1.0)
    return {"rmse": math.sqrt(float(sums["sse"]) / n),
            "abs_rel": float(sums["sabs_rel"]) / n,
            "delta_1.25": float(sums["sdelta"]) / n}
