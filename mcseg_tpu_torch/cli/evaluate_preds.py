"""Score dumped predictions: the per-class IoU table of a directory of
predicted label PNGs against a directory of ground-truth label PNGs (the
JAX package's ``cli/evaluate_preds.py``).

Predictions are ``*_label.png`` (the tester's ``--outdir`` dumps), else
every ``*.png``; each is scored against the GT PNG of the same stem
(``000000_label.png`` against ``000000.png``). ``--gt_raw`` maps raw
corpus ids through the corpus's remap table first. The histogram is
``eval.metrics.fast_hist`` on the device, so the score is the tester's.

    python -m mcseg_tpu_torch.cli.evaluate_preds preds/ gt/ --dataset nyu
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.eval.metrics import fast_hist, format_iou_table, miou_from_hist
from mcseg_tpu_torch.ops.preprocess import remap_labels


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def main(argv=None, device="cuda"):
    """Score on ``device``; prints the IoU table and returns the mIoU."""
    p = argparse.ArgumentParser("evaluate_preds")
    p.add_argument("pred_dir")
    p.add_argument("gt_dir")
    p.add_argument("--dataset", default="nyu", help="label space: nyu|suncg|city|gta5")
    p.add_argument("--gt_raw", action="store_true",
                   help="GT PNGs hold raw corpus ids (apply the remap table)")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    n_class, table, names, _ = get_label_spec(args.dataset)
    preds = sorted(glob.glob(os.path.join(args.pred_dir, "*_label.png"))) or sorted(
        glob.glob(os.path.join(args.pred_dir, "*.png")))
    if not preds:
        raise FileNotFoundError(f"no prediction PNGs in {args.pred_dir}")

    hist = torch.zeros((n_class, n_class), dtype=torch.int64, device=dev)
    n_used = 0
    for pred_path in preds:
        stem = os.path.basename(pred_path).replace("_label", "")
        gt_path = os.path.join(args.gt_dir, stem)
        if not os.path.exists(gt_path):
            continue
        pred = torch.from_numpy(_read_png(pred_path).astype(np.int64)).to(dev)
        gt = torch.from_numpy(_read_png(gt_path).astype(np.int64)).to(dev)
        if args.gt_raw:
            gt = remap_labels(gt, table)
        hist += fast_hist(gt, pred.clamp(0, n_class - 1), n_class)
        n_used += 1
    if n_used == 0:
        raise FileNotFoundError("no (pred, gt) filename matches")
    hist = hist.cpu().numpy()
    print(f"evaluated {n_used} images")
    print(format_iou_table(hist, names[:n_class]))
    return miou_from_hist(hist)


if __name__ == "__main__":
    main()
