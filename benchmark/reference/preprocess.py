"""Plain reference of the input preprocess: raw planes -> the normalized
input stack [B, C, H, W] (float32) and the train labels.

Train (``train_inputs``): the raw ids go through the configuration's
label map (unmapped -> 255); RGB/255 and HHA/255 (HHA encoded from the
depth plane, ``reference/hha.py``) are sampled bilinearly, two taps per
axis, at the positions of a crop of the pre-crop canvas; labels at the
nearest position; then the per-sample horizontal flip and the per-channel
(x - mean) / std with the ImageNet statistics, for HHA too. The canvas is
the target enlarged by 1 / sqrt(crop_scale_min); the cells' canvases are
larger than their decode sizes, so the crop samples the decode-size planes
directly. Crop offsets and flips are drawn per iteration from a CPU
generator seeded by ``(seed + 1, iteration)`` (``draws``).

Serve (``serve_inputs``): the same stack at the decode size, with no crop
and no flip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
IGNORE = 255


def label_table(label_map: Dict[str, int], device) -> torch.Tensor:
    """[256] lookup from raw id to train id, 255 where unmapped."""
    table = torch.full((256,), IGNORE, dtype=torch.long)
    for raw, train in label_map.items():
        table[int(raw)] = int(train)
    return table.to(device)


def canvas(hw: Tuple[int, int], crop_scale_min: float) -> Tuple[int, int]:
    s = np.sqrt(crop_scale_min)
    return int(np.ceil(hw[0] / s)), int(np.ceil(hw[1] / s))


def draws(seed: int, iteration: int, b: int, hw, pre):
    """(tops, lefts, flip) of the source batch, then of the target batch."""
    mixed = np.random.SeedSequence([seed + 1, iteration]).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed) & (2**63 - 1))
    out = []
    for _ in range(2):
        tops = torch.randint(0, pre[0] - hw[0] + 1, (b,), generator=gen, dtype=torch.int32)
        lefts = torch.randint(0, pre[1] - hw[1] + 1, (b,), generator=gen, dtype=torch.int32)
        flip = torch.rand(b, generator=gen) < 0.5
        out.append((tops, lefts, flip))
    return out


def _positions(n: int, size: int, pre: int, offsets: torch.Tensor) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float32, device=offsets.device)
    scale = torch.tensor(size / pre, dtype=torch.float32, device=offsets.device)
    return (offsets.to(torch.float32)[:, None] + i[None, :] + 0.5) * scale - 0.5


def _sample(x: torch.Tensor, t_rows: torch.Tensor, t_cols: torch.Tensor) -> torch.Tensor:
    """x [B, h, w, C] bilinearly at per-sample rows [B, H] and cols [B, W]
    (taps clamped to the edge)."""
    b, h, w, c = x.shape
    r0 = torch.floor(t_rows)
    c0 = torch.floor(t_cols)
    wr, wc = (t_rows - r0)[:, :, None, None], (t_cols - c0)[:, None, :, None]
    r0, c0 = r0.long(), c0.long()
    rows = [r.clamp(0, h - 1) for r in (r0, r0 + 1)]
    cols = [q.clamp(0, w - 1) for q in (c0, c0 + 1)]
    bi = torch.arange(b, device=x.device)[:, None, None]

    def at(r, q):
        return x[bi, r[:, :, None], q[:, None, :]]

    top = at(rows[0], cols[0]) * (1 - wc) + at(rows[0], cols[1]) * wc
    bottom = at(rows[1], cols[0]) * (1 - wc) + at(rows[1], cols[1]) * wc
    return top * (1 - wr) + bottom * wr


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] in [0, 1] -> (x - mean) / std per channel, RGB's
    statistics repeated for the extra planes."""
    c = x.shape[-1]
    mean = torch.tensor((MEAN * 2)[:c], device=x.device)
    std = torch.tensor((STD * 2)[:c], device=x.device)
    return (x - mean) / std


def _planes01(batch: Dict[str, torch.Tensor], input_ch: int) -> torch.Tensor:
    from benchmark.reference.hha import depth_to_hha

    x = batch["image"].to(torch.float32) / 255.0
    if input_ch == 6:
        x = torch.cat([x, depth_to_hha(batch["depth"]) / 255.0], dim=-1)
    elif input_ch != 3:
        raise ValueError(f"the reference covers input_ch 3 and 6, not {input_ch}")
    return x


def train_inputs(batch, input_ch, table, hw, pre, tops, lefts, flip):
    """(x [B, C, H, W] float32, labels [B, H, W] long or None)."""
    x = _planes01(batch, input_ch)
    h0, w0 = x.shape[1:3]
    if not (pre[0] >= h0 and pre[1] >= w0):
        raise ValueError("the reference samples crops from a canvas larger than "
                         f"the decode size; got canvas {pre} for {(h0, w0)}")
    dev = x.device
    t_rows = _positions(hw[0], h0, pre[0], tops.to(dev))
    t_cols = _positions(hw[1], w0, pre[1], lefts.to(dev))
    x = _sample(x, t_rows, t_cols)
    f = flip.to(dev)[:, None, None]
    x = torch.where(f[..., None], x.flip(2), x)
    label = batch.get("label")
    if label is not None:
        rows = torch.floor(t_rows + 0.5).clamp(0, h0 - 1).long()
        cols = torch.floor(t_cols + 0.5).clamp(0, w0 - 1).long()
        bi = torch.arange(label.shape[0], device=dev)[:, None, None]
        label = table[label.long()][bi, rows[:, :, None], cols[:, None, :]]
        label = torch.where(f, label.flip(2), label)
    return _normalize(x).permute(0, 3, 1, 2).contiguous(), label


def serve_inputs(batch, input_ch) -> torch.Tensor:
    return _normalize(_planes01(batch, input_ch)).permute(0, 3, 1, 2).contiguous()
