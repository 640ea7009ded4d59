"""SUNCG physically-based renders (PBRS-style trees) -> the readers'
``<split>_rgb / _label / _depth`` layout.

The port of the JAX package's ``tools/organize_suncg.py``. The renders are
per-house directories of numbered frames:

    <root>/<house_id>/000012_mlt.png          colour render
    <root>/<house_id>/000012_category40.png   NYU-40 label render
    <root>/<house_id>/000012_depth.png        16-bit depth (mm)

Frames are paired by their stem (the path with the suffix removed); a
frame without a label is skipped. Files are hardlinked (or copied) to
``<out>/<split>_rgb|_label|_depth/<house_id>_<frame>.png``.

    python -m mcseg_tpu_torch.tools.organize_suncg /renders --out /data/suncg \
        [--split train] [--rgb_suffix _mlt.png] \
        [--label_suffix _category40.png] [--depth_suffix _depth.png] [--copy]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil


def _link(src: str, dst: str, copy: bool) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    if os.path.exists(dst):
        os.remove(dst)
    if copy:
        shutil.copy2(src, dst)
        return
    try:
        os.link(src, dst)
    except OSError:  # another device: copy instead
        shutil.copy2(src, dst)


def organize(root: str, out: str, split: str = "train", rgb_suffix: str = "_mlt.png",
             label_suffix: str = "_category40.png", depth_suffix: str = "_depth.png",
             copy: bool = False) -> int:
    """Link the labelled frames under ``root`` into ``out``; returns their count."""
    rgbs = sorted(glob.glob(os.path.join(root, "**", f"*{rgb_suffix}"), recursive=True))
    n = 0
    for rgb in rgbs:
        stem = rgb[: -len(rgb_suffix)]
        label = stem + label_suffix
        if not os.path.exists(label):
            continue
        rel = os.path.relpath(stem, root).replace(os.sep, "_")
        _link(rgb, os.path.join(out, f"{split}_rgb", rel + ".png"), copy)
        _link(label, os.path.join(out, f"{split}_label", rel + ".png"), copy)
        depth = stem + depth_suffix
        if os.path.exists(depth):
            _link(depth, os.path.join(out, f"{split}_depth", rel + ".png"), copy)
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser("organize_suncg")
    p.add_argument("root", help="render tree (per-house directories)")
    p.add_argument("--out", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--rgb_suffix", default="_mlt.png")
    p.add_argument("--label_suffix", default="_category40.png")
    p.add_argument("--depth_suffix", default="_depth.png")
    p.add_argument("--copy", action="store_true", help="copy instead of hardlinking")
    args = p.parse_args(argv)
    n = organize(args.root, args.out, args.split, args.rgb_suffix, args.label_suffix,
                 args.depth_suffix, args.copy)
    print(f"organized {n} frames into {args.out}")


if __name__ == "__main__":
    main()
