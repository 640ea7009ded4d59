"""mIoU evaluation: confusion matrix by bincount, per-class IoU.

Rows are ground truth, columns prediction; per-class IoU = diag / (rowsum
+ colsum - diag); mIoU is the mean over classes present in GT or
prediction (NaN classes skipped).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from mcseg_tpu_torch.data.labels import IGNORE


def fast_hist(gt: torch.Tensor, pred: torch.Tensor, n_class: int) -> torch.Tensor:
    """Confusion matrix [n_class, n_class] (int64) on the tensors' device.
    Pixels whose GT is IGNORE or out of range fall into one extra bin that
    is dropped."""
    gt = gt.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = (gt >= 0) & (gt < n_class) & (gt != IGNORE)
    idx = torch.where(valid, gt * n_class + pred, n_class * n_class)
    hist = torch.bincount(idx, minlength=n_class * n_class + 1)[:-1]
    return hist.reshape(n_class, n_class)


def per_class_iu(hist) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    denom = hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        iu = np.diag(hist) / denom
    return iu  # NaN for classes absent from both GT and prediction


def miou_from_hist(hist) -> float:
    return float(np.nanmean(per_class_iu(hist)))


def pixel_accuracy(hist) -> float:
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    return float(np.diag(hist).sum() / total) if total else 0.0


def format_iou_table(hist, class_names: Optional[Sequence[str]] = None) -> str:
    """Human-readable per-class IoU table, like the reference testers print."""
    iu = per_class_iu(hist)
    n = len(iu)
    if class_names is None:
        class_names = [f"class_{i}" for i in range(n)]
    width = max(len(c) for c in class_names) + 2
    lines = ["per-class IoU:"]
    for name, v in zip(class_names, iu):
        sv = "  n/a" if np.isnan(v) else f"{100.0 * v:5.1f}"
        lines.append(f"  {name:<{width}} {sv}")
    lines.append(f"mIoU: {100.0 * np.nanmean(iu):.2f}")
    lines.append(f"pixel acc: {100.0 * pixel_accuracy(hist):.2f}")
    return "\n".join(lines)
