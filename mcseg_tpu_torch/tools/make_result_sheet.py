"""Result sheets: input | GT | prediction tiles side by side, one PNG per
prediction (the JAX package's ``tools/make_result_sheet.py``).

For each ``*_label.png`` in the prediction directory (the tester's
``--outdir`` dumps, at most ``--limit``), the input image and the GT of the
same stem are found where they exist, resized to the prediction's size
(the GT nearest-neighbour) and coloured through the corpus palette with
``data.transforms.colorize``. Host work only: PIL decodes and encodes.

    python -m mcseg_tpu_torch.tools.make_result_sheet <rgb_dir> <gt_dir> <pred_dir> <out_dir> \\
        --dataset nyu
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.data.transforms import colorize


def _find(d, stem):
    for ext in (".png", ".jpg"):
        q = os.path.join(d, stem + ext)
        if os.path.exists(q):
            return q
    hits = glob.glob(os.path.join(d, stem + "*"))
    return hits[0] if hits else None


def main(argv=None):
    """Write the sheets; returns their paths."""
    from PIL import Image

    p = argparse.ArgumentParser("make_result_sheet")
    p.add_argument("rgb_dir")
    p.add_argument("gt_dir")
    p.add_argument("pred_dir")
    p.add_argument("out_dir")
    p.add_argument("--dataset", default="nyu")
    p.add_argument("--limit", type=int, default=50)
    args = p.parse_args(argv)

    _, _, _, palette = get_label_spec(args.dataset)
    os.makedirs(args.out_dir, exist_ok=True)
    preds = sorted(glob.glob(os.path.join(args.pred_dir, "*_label.png")))[: args.limit]
    written = []
    for pred_path in preds:
        stem = os.path.basename(pred_path).replace("_label.png", "")
        panels = []
        rgb_path = _find(args.rgb_dir, stem)
        gt_path = _find(args.gt_dir, stem)
        pred = np.asarray(Image.open(pred_path))
        size = (pred.shape[1], pred.shape[0])
        if rgb_path:
            panels.append(np.asarray(Image.open(rgb_path).convert("RGB").resize(size)))
        if gt_path:
            gt = np.asarray(Image.open(gt_path).resize(size, Image.NEAREST))
            panels.append(colorize(gt, palette))
        panels.append(colorize(pred, palette))
        out = os.path.join(args.out_dir, f"{stem}_sheet.png")
        Image.fromarray(np.concatenate(panels, axis=1)).save(out)
        written.append(out)
    print(f"wrote {len(preds)} sheets to {args.out_dir}")
    return written


if __name__ == "__main__":
    main()
