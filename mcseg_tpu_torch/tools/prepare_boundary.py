"""Label maps -> boundary edge maps, the plane of ``--input_ch 7`` (and of
``--input_ch 4`` without depth).

The port of the JAX package's ``tools/prepare_boundary.py``: a pixel is an
edge pixel iff a 4-neighbour carries a different valid class, the rule of
``losses/seg.py boundary_targets_from_labels``, so the offline plane and
the boundary head's targets agree. Writes 0/255 PNGs into a
``<split>_boundary/`` directory the readers pick up.

    python -m mcseg_tpu_torch.tools.prepare_boundary <label_dir> <out_dir> \
        [--ignore_index 255] [--dilate N]

``--dilate N`` thickens the edges by N rounds of 4-neighbour dilation.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from mcseg_tpu_torch.data.transforms import save_png


def labels_to_boundary(label: np.ndarray, ignore_index: int = 255,
                       dilate: int = 0) -> np.ndarray:
    """uint8 label map [H, W] -> uint8 {0, 255} edge map [H, W]; both sides
    of a class edge are marked, an edge against an ignored pixel is none."""
    lbl = label.astype(np.int32)
    valid = label != ignore_index
    boundary = np.zeros(label.shape, bool)
    edge_v = (lbl[1:, :] != lbl[:-1, :]) & valid[1:, :] & valid[:-1, :]
    boundary[1:, :] |= edge_v
    boundary[:-1, :] |= edge_v
    edge_h = (lbl[:, 1:] != lbl[:, :-1]) & valid[:, 1:] & valid[:, :-1]
    boundary[:, 1:] |= edge_h
    boundary[:, :-1] |= edge_h
    for _ in range(dilate):
        grown = boundary.copy()
        grown[1:, :] |= boundary[:-1, :]
        grown[:-1, :] |= boundary[1:, :]
        grown[:, 1:] |= boundary[:, :-1]
        grown[:, :-1] |= boundary[:, 1:]
        boundary = grown
    return boundary.astype(np.uint8) * 255


def main(argv=None):
    p = argparse.ArgumentParser("prepare_boundary")
    p.add_argument("label_dir")
    p.add_argument("out_dir")
    p.add_argument("--ignore_index", type=int, default=255)
    p.add_argument("--dilate", type=int, default=0,
                   help="thicken edges by N 4-neighbour dilation rounds")
    args = p.parse_args(argv)

    from PIL import Image  # reads the label files; the outputs need no image library

    paths = sorted(glob.glob(os.path.join(args.label_dir, "*")))
    if not paths:
        raise SystemExit(f"no label files under {args.label_dir!r}")
    os.makedirs(args.out_dir, exist_ok=True)
    for path in paths:
        lbl = np.asarray(Image.open(path))
        if lbl.ndim != 2:
            raise SystemExit(f"{path}: expected a single-channel label PNG, got shape "
                             f"{lbl.shape}")
        stem = os.path.splitext(os.path.basename(path))[0]
        save_png(labels_to_boundary(lbl, args.ignore_index, args.dilate),
                 os.path.join(args.out_dir, stem + ".png"))
    print(f"wrote {len(paths)} boundary maps to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
