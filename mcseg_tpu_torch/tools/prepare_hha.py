"""Depth maps -> HHA planes, offline.

The port of the JAX package's ``tools/prepare_hha.py``: the port's own HHA
encoder (``ops/hha.py``, the one the preprocess runs) over a directory of
16-bit depth PNGs in millimetres (or TIFFs), written as uint8 HHA PNGs, so
the offline and the online planes agree by construction.

    python -m mcseg_tpu_torch.tools.prepare_hha <depth_dir> <out_dir> \
        [--fx F --fy F --cx C --cy C] [--batch 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from mcseg_tpu_torch.data.transforms import save_png
from mcseg_tpu_torch.ops.hha import CameraIntrinsics, default_intrinsics, depth_to_hha_batch


def load_depth_m(path: str) -> np.ndarray:
    """A depth image in metres: values above 256 are read as millimetres,
    as the JAX tool reads them."""
    from PIL import Image

    arr = np.asarray(Image.open(path)).astype(np.float32)
    if arr.max() > 256:
        arr = arr / 1000.0
    return arr


def main(argv=None):
    p = argparse.ArgumentParser("prepare_hha")
    p.add_argument("depth_dir")
    p.add_argument("out_dir")
    p.add_argument("--fx", type=float, default=None)
    p.add_argument("--fy", type=float, default=None)
    p.add_argument("--cx", type=float, default=None)
    p.add_argument("--cy", type=float, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--device", default="cpu", help="where the encoder runs")
    args = p.parse_args(argv)

    paths = sorted(glob.glob(os.path.join(args.depth_dir, "*.png"))
                   + glob.glob(os.path.join(args.depth_dir, "*.tif")))
    if not paths:
        raise FileNotFoundError(f"no depth images in {args.depth_dir}")
    os.makedirs(args.out_dir, exist_ok=True)
    h, w = load_depth_m(paths[0]).shape
    K = (CameraIntrinsics(args.fx, args.fy or args.fx, args.cx or w / 2, args.cy or h / 2)
         if args.fx else default_intrinsics(h, w))
    for i in range(0, len(paths), args.batch):
        chunk = paths[i : i + args.batch]
        depths = torch.from_numpy(np.stack([load_depth_m(q) for q in chunk])).to(args.device)
        hha = depth_to_hha_batch(depths, K).cpu().numpy()
        for q, img in zip(chunk, hha):
            stem = os.path.splitext(os.path.basename(q))[0]
            save_png(img.astype(np.uint8), os.path.join(args.out_dir, stem + ".png"))
        print(f"{min(i + args.batch, len(paths))}/{len(paths)}", flush=True)


if __name__ == "__main__":
    main()
