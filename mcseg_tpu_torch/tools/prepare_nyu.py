"""The official NYU Depth v2 distribution -> the readers' nyu layout.

The port of the JAX package's ``tools/prepare_nyu.py``. Inputs, the three
standard files:

  nyu_depth_v2_labeled.mat   MATLAB v7.3 (HDF5): 'images' [N,3,W,H] uint8,
                             'depths' [N,W,H] float metres
  labels40.mat               the 40-class labels of the 1449 frames:
                             'labels40' [H,W,N] (MATLAB v5, or v7.3)
  splits.mat                 'trainNdxs', 'testNdxs' (1-based, MATLAB v5)

Output under --out: ``train_rgb/0001.png``, ``train_label/``,
``train_depth/`` (16-bit mm) and the same for ``val_``. h5py and scipy are
imported when the tool runs.

    python -m mcseg_tpu_torch.tools.prepare_nyu nyu_depth_v2_labeled.mat \
        --labels40 labels40.mat --splits splits.mat --out /data/nyu
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from mcseg_tpu_torch.data.transforms import save_png


def _save(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_png(arr, path)


def _load_splits(path: str, n: int):
    import scipy.io

    m = scipy.io.loadmat(path)
    train = m["trainNdxs"].ravel().astype(int) - 1  # 1-based -> 0-based
    test = m["testNdxs"].ravel().astype(int) - 1
    if max(train.max(), test.max()) >= n:
        raise ValueError(f"{path}: split indices beyond the {n} frames")
    return train, test


def _load_labels40(path: str) -> np.ndarray:
    """[N, H, W] uint8 from a MATLAB v5 file, or from a v7.3 (HDF5) one."""
    import scipy.io

    try:
        return np.transpose(scipy.io.loadmat(path)["labels40"], (2, 0, 1)).astype(np.uint8)
    except NotImplementedError:  # v7.3
        import h5py

        with h5py.File(path, "r") as f:
            return np.transpose(np.asarray(f["labels40"]), (0, 2, 1)).astype(np.uint8)


def convert(labeled_mat: str, labels40_mat: str, splits_mat: str, out: str,
            depth_scale_mm: float = 1000.0, limit: Optional[int] = None) -> int:
    """Write the train and val frames; returns how many were written."""
    import h5py

    with h5py.File(labeled_mat, "r") as f:
        images, depths = f["images"], f["depths"]
        n = images.shape[0]
        labels40 = _load_labels40(labels40_mat)
        if labels40.shape[0] != n:
            raise ValueError(f"labels40 holds {labels40.shape[0]} frames, the .mat {n}")
        train_idx, test_idx = _load_splits(splits_mat, n)
        written = 0
        for split, idxs in (("train", train_idx), ("val", test_idx)):
            for j, i in enumerate(idxs):
                if limit is not None and j >= limit:
                    break
                rgb = np.transpose(np.asarray(images[i]), (2, 1, 0))  # H, W, 3
                depth_mm = np.clip(np.asarray(depths[i]).T * depth_scale_mm, 0, 65535)
                stem = f"{int(i) + 1:04d}.png"
                _save(os.path.join(out, f"{split}_rgb", stem), rgb.astype(np.uint8))
                _save(os.path.join(out, f"{split}_label", stem), labels40[i])
                _save(os.path.join(out, f"{split}_depth", stem), depth_mm.astype(np.uint16))
                written += 1
    return written


def main(argv=None):
    p = argparse.ArgumentParser("prepare_nyu")
    p.add_argument("labeled_mat", help="nyu_depth_v2_labeled.mat (HDF5)")
    p.add_argument("--labels40", required=True, help="labels40.mat")
    p.add_argument("--splits", required=True, help="splits.mat")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None, help="frames per split at most")
    args = p.parse_args(argv)
    n = convert(args.labeled_mat, args.labels40, args.splits, args.out, limit=args.limit)
    print(f"wrote {n} frames under {args.out}")


if __name__ == "__main__":
    main()
