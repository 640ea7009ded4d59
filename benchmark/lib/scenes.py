"""The one traffic generator: procedural RGB-D scenes drawn on the card
from the seed, from the parameters of a traffic file's ``scene`` section
(``width``, ``height``, the raw ids ``classes``, ``depth``).

A scene is a floor plane (raw id ``classes[0]``) whose depth runs from
``FLOOR_DEPTH_M[1]`` at the top row to ``FLOOR_DEPTH_M[0]`` at the bottom,
with ``BOXES`` = [lo, hi] rectangles stacked over it in depth: each box
takes a raw id drawn uniformly from ``classes``, a width from w/8 to w/2 -
1, a height from h/8 to h/2 - 1, a position inside the frame and a depth
drawn uniformly from ``BOX_DEPTH_M``, and paints only where it is nearer
than what is there (so the depths order the boxes even where no depth
plane is emitted). The colour of the class at position p of ``classes``
is ((p + 2) * (53, 101, 197)) mod 255,
plus Gaussian noise of ``NOISE_STD``; a domain shift s (``SOURCE_SHIFT``
for training's source batches, ``TARGET_SHIFT`` for its target batches and
for served requests) blends each colour a = min(0.4 s, 0.45) toward the
previous class's, scales the channels by (1 + 0.2 s, 1 - 0.15 s, 1 + 0.1
s), adds 14 s and widens the noise by 4 s. A share ``VOID_SHARE`` of the
pixels gets the raw id ``VOID``. The planes: uint8 RGB [n, H, W, 3], uint8
raw labels [n, H, W], and, where ``depth`` is set, float32 depth in metres
[n, H, W].

It follows the program's ``synthetic`` / ``synthetic_shifted`` corpora
(a floor and boxes of raw NYUDv2 ids, the same palette and shift),
vectorized over the batch, drawn on the device, with its raw ids taken
from the traffic file (Cityscapes' label ids for a street-scene label
space).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

COLOUR_STEP = (53, 101, 197)
BOXES = (4, 8)  # [lo, hi] boxes a scene
BOX_DEPTH_M = (0.5, 3.0)
FLOOR_DEPTH_M = (1.5, 3.5)  # nearest (bottom row), farthest (top row)
NOISE_STD = 12.0
VOID, VOID_SHARE = 0, 0.01  # raw id, share of the pixels
SOURCE_SHIFT, TARGET_SHIFT = 0.0, 1.0


def _ids(v):
    ok = isinstance(v, list) and v and all(isinstance(x, int) and 0 <= x < 255 for x in v)
    return None if ok else "must be a list of raw ids 0-254"


def _positive_int(v):
    ok = isinstance(v, int) and not isinstance(v, bool) and v > 0
    return None if ok else "must be a positive int"


# the keys of a traffic file's ``scene`` section (``benchmark/lib/spec.py``)
SCENE = {"width": _positive_int, "height": _positive_int, "classes": _ids, "depth": bool}


def generator(seed: int, *stream: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` for the stream ``(seed, *stream)``."""
    mixed = np.random.SeedSequence([seed, *stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed) & (2**63 - 1))


def _palette(classes, shift: float, device) -> torch.Tensor:
    rows = np.arange(1, len(classes) + 2)[:, None] * np.array([COLOUR_STEP]) % 255
    base = rows.astype(np.float64)
    if shift > 0:
        a = min(0.40 * shift, 0.45)
        base = (1.0 - a) * base + a * np.roll(base, 1, axis=0)
        gain = np.array([1.0 + 0.20 * shift, 1.0 - 0.15 * shift, 1.0 + 0.10 * shift])
        base = np.clip(base * gain + 14.0 * shift, 0.0, 255.0)
    return torch.tensor(base[1:], dtype=torch.float32, device=device)  # row p: class p


def scenes(scene: Dict, n: int, shift: float, gen: torch.Generator, labels: bool = True
           ) -> Dict[str, torch.Tensor]:
    """``n`` scenes of ``scene``'s parameters under domain ``shift``."""
    dev = gen.device
    h, w = scene["height"], scene["width"]
    classes = torch.tensor(scene["classes"], dtype=torch.long, device=dev)
    lo, hi = BOXES
    z_lo, z_hi = BOX_DEPTH_M
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    near, far = FLOOR_DEPTH_M
    depth = torch.linspace(far, near, h, device=dev)[None, :, None].repeat(n, 1, w)
    pos = torch.zeros((n, h, w), dtype=torch.long, device=dev)
    n_boxes = torch.randint(lo, hi + 1, (n,), generator=gen, device=dev)

    def uniform_int(low, high):  # per-sample [low, high)
        r = torch.rand(n, generator=gen, device=dev)
        return low + (r * (high - low)).long()

    for k in range(hi):
        cls = torch.randint(0, len(scene["classes"]), (n,), generator=gen, device=dev)
        bw = torch.randint(w // 8, w // 2, (n,), generator=gen, device=dev)
        bh = torch.randint(h // 8, h // 2, (n,), generator=gen, device=dev)
        x0, y0 = uniform_int(0, w - bw), uniform_int(0, h - bh)
        z = z_lo + (z_hi - z_lo) * torch.rand(n, generator=gen, device=dev)
        inside = ((rows >= y0[:, None, None]) & (rows < (y0 + bh)[:, None, None])
                  & (cols >= x0[:, None, None]) & (cols < (x0 + bw)[:, None, None]))
        paint = inside & (depth > z[:, None, None]) & (k < n_boxes)[:, None, None]
        depth = torch.where(paint, z[:, None, None], depth)
        pos = torch.where(paint, cls[:, None, None], pos)
    std = NOISE_STD + 4.0 * shift
    img = _palette(scene["classes"], shift, dev)[pos]
    img = img + torch.randn((n, h, w, 3), generator=gen, device=dev) * std
    out = {"image": img.clamp(0.0, 255.0).to(torch.uint8)}
    if labels:
        raw = classes[pos]
        void = torch.rand((n, h, w), generator=gen, device=dev) < VOID_SHARE
        out["label"] = torch.where(void, VOID, raw).to(torch.uint8)
    if scene["depth"]:
        out["depth"] = depth.to(torch.float32)
    return out
