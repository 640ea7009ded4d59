"""Preprocess on the device: raw planes -> normalized input stack.

The port of the JAX package's ``ops/preprocess.py``. Eval:

  raw uint8 RGB [B,h,w,3] (+ float metres | uint16 mm depth [B,h,w], or a
  precomputed uint8 HHA plane, an 'ir' or a 'boundary' plane)
      -> label remap (one gather through the corpus table)
      -> the extra planes: depth -> HHA (ops.hha) for input_ch 6, HHA and
         the binarized boundary plane for 7, one depth-like plane for 1
         and 4 (``_extra_channels``)
      -> bilinear resize to test_img_shape, skipped when the decode size
         already equals it (exact: the resize is then the identity)
      -> fused normalize/stack (ops.normalize, the CUDA kernel on the card)

Labels are remapped but not resized: mIoU is scored at the native label
resolution against logits upsampled by the tester.

Train (``make_train_preprocess``): the same planes, resized to a pre-crop
canvas and cropped at per-sample offsets (bilinear for RGB and HHA, nearest
for labels), then the per-sample flip and the normalize/stack in the same
kernel. The random draws (``draw_augment``) are explicit inputs. The
multitask trainer's source batches also carry their depth plane in metres
through the same geometry and flip (``with_depth``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.core.device import to_device
from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
from mcseg_tpu_torch.ops.upsample import resize_image_nchw
from mcseg_tpu_torch.utils.profiler import span


def depth_to_meters(d: torch.Tensor) -> torch.Tensor:
    """Accept both depth wire formats: float32 metres or uint16 millimetres."""
    if d.dtype == torch.uint16:
        return d.to(torch.float32) * 0.001
    return d.to(torch.float32)


def remap_labels(label: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Raw corpus ids -> train ids (IGNORE where unmapped), int32."""
    lut = to_device(torch.as_tensor(np.asarray(table, np.int32)), label.device)
    return lut[label.long()]


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[B,h,w,C] float -> [B,H,W,C], half-pixel bilinear with the JAX
    ``jax.image.resize`` semantics: antialiased (a widened triangle) along
    a downscaled axis, plain two-tap along an upscaled one."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return resize_image_nchw(x.permute(0, 3, 1, 2), *hw).permute(0, 2, 3, 1).contiguous()


def _extra_channels(batch: Dict[str, torch.Tensor], input_ch: int,
                    hha_on_device: bool = False) -> Optional[torch.Tensor]:
    """Non-RGB channels in [0, 1], [B,h,w,E]: none for input_ch 3, HHA for
    6, HHA and the binarized boundary plane for 7, one plane for 1 and 4.

    ``hha_on_device`` picks the HHA source when the batch carries both a
    precomputed 'hha' plane and raw 'depth': True encodes from depth. The
    plane of 1 and 4 is, in this order of preference: depth over the
    largest depth of the whole batch (taken on the raw planes, before any
    resize or crop, at least 1 mm), the HHA disparity plane / 255, 'ir' /
    255, or 'boundary' > 0."""
    if input_ch == 3:
        return None
    has_hha = batch.get("hha") is not None
    has_depth = batch.get("depth") is not None
    if input_ch in (6, 7):
        if has_hha and not (hha_on_device and has_depth):
            hha = batch["hha"].to(torch.float32) / 255.0
        elif has_depth:
            hha = depth_to_hha_batch(depth_to_meters(batch["depth"])) / 255.0
        else:
            raise ValueError(f"input_ch={input_ch} needs 'hha' or 'depth' in the batch")
        if input_ch == 6:
            return hha
        if batch.get("boundary") is None:
            raise ValueError("input_ch=7 needs 'boundary' plus 'hha'/'depth' in the batch")
        return torch.cat([hha, (batch["boundary"] > 0).to(torch.float32)[..., None]], dim=-1)
    if input_ch in (1, 4):
        if has_depth:
            depth = depth_to_meters(batch["depth"])
            return (depth / depth.max().clamp(min=1e-3))[..., None]
        if has_hha:  # the disparity plane as a depth proxy
            return batch["hha"][..., 0:1].to(torch.float32) / 255.0
        if batch.get("ir") is not None:  # multispectral 4th channel
            return batch["ir"].to(torch.float32)[..., None] / 255.0
        if batch.get("boundary") is not None:  # edge map as the 4th channel
            return (batch["boundary"] > 0).to(torch.float32)[..., None]
        raise ValueError(f"input_ch={input_ch} needs 'depth', 'hha', 'ir' or "
                         "'boundary' in the batch")
    raise ValueError(f"unsupported input_ch {input_ch}")


def make_eval_preprocess(cfg: DataConfig,
                         out_dtype: torch.dtype = torch.float32) -> Callable:
    """Deterministic eval preprocess:
    ``batch -> (img [B,H,W,input_ch] out_dtype, label)``.

    ``batch`` holds tensors on one device; 'label' is optional (serving
    sends none) and comes back remapped at its native resolution, int32."""
    tw, th = cfg.test_img_shape
    target = (th, tw)
    _, table, _, _ = get_label_spec(cfg.tgt_dataset)

    def preprocess(batch: Dict[str, torch.Tensor]):
        image = batch["image"]
        label = batch.get("label")
        if label is not None:
            label = remap_labels(label, table)
        extra = _extra_channels(batch, cfg.input_ch, cfg.hha_on_device)
        # the kernel reads uint8 RGB directly at the target size; a resized
        # geometry hands it float RGB in [0, 1] instead
        if tuple(image.shape[1:3]) == target:
            rgb = image.contiguous()
        else:
            rgb = resize_bilinear(image.to(torch.float32) / 255.0, target)
        if extra is not None:
            extra = resize_bilinear(extra, target).contiguous()
        flip = torch.zeros(image.shape[0], dtype=torch.int32, device=image.device)
        img = fused_normalize_stack(rgb, extra, flip, cfg.input_ch, out_dtype)
        return img, label

    return preprocess


def _positions(out_size: int, in_size: int, pre_size: int,
               offsets: torch.Tensor) -> torch.Tensor:
    """[B, out_size] source positions ``t(i) = (offset + i + 0.5) * in/pre
    - 0.5`` of the canvas of ``pre_size`` cropped at ``offset``, on an axis
    of ``in_size``. float32 in JAX's order of operations
    (``ops/preprocess.py:_interp_matrix``), so that nearest indices agree
    bit for bit near a tie."""
    i = torch.arange(out_size, dtype=torch.float32, device=offsets.device)
    scale = to_device(torch.tensor(in_size / pre_size, dtype=torch.float32), offsets.device)
    return (offsets.to(torch.float32)[:, None] + i[None, :] + 0.5) * scale - 0.5


def _taps(t: torch.Tensor, in_size: int):
    """Two-tap bilinear sampling at t: (i0, i1, w1). Taps outside the axis
    are clamped to its edge, which equals the JAX weights'
    renormalization there."""
    j0 = torch.floor(t)
    w1 = t - j0
    j0 = j0.long()
    return j0.clamp(0, in_size - 1), (j0 + 1).clamp(0, in_size - 1), w1


def _nearest(t: torch.Tensor, in_size: int) -> torch.Tensor:
    return torch.floor(t + 0.5).clamp(0, in_size - 1).long()


def _gather_rows(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x [B, H, W, ...] sampled at per-sample indices idx [B, n] along
    ``dim`` (1 = rows, 2 = columns)."""
    shape = list(x.shape)
    shape[dim] = idx.shape[1]
    view = [idx.shape[0], 1, 1] + [1] * (x.dim() - 3)
    view[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.view(view).expand(shape))


def _lerp_axis(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    i0, i1, w1 = taps
    view = [w1.shape[0], 1, 1] + [1] * (x.dim() - 3)
    view[dim] = w1.shape[1]
    w1 = w1.view(view)
    return _gather_rows(x, i0, dim) * (1.0 - w1) + _gather_rows(x, i1, dim) * w1


def _crop(x: torch.Tensor, tops, lefts, hw: Tuple[int, int]) -> torch.Tensor:
    """Per-sample window [top:top+h, left:left+w] of x [B, H, W, ...]."""
    rows = tops.long()[:, None] + torch.arange(hw[0], device=x.device)
    cols = lefts.long()[:, None] + torch.arange(hw[1], device=x.device)
    return _gather_rows(_gather_rows(x, rows, 1), cols, 2)


def _resize_nearest_labels(label: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(method='nearest')`` as XLA compiles it: index
    floor((i + 0.5) * (in / out)) in float32 (XLA folds the source's
    ``* in / out`` into one multiply by the float32 quotient, which moves
    exact ties such as 43.5 * 72 / 58 = 54 to the index below)."""
    out = label
    for dim, n in ((1, hw[0]), (2, hw[1])):
        m = label.shape[dim]
        if m == n:
            continue
        scale = to_device(torch.tensor(np.float32(m) / np.float32(n)), label.device)
        pos = (torch.arange(n, dtype=torch.float32, device=label.device) + 0.5) * scale
        out = out.index_select(dim, torch.floor(pos).long())
    return out


def pre_crop_canvas(cfg: DataConfig) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((pre_h, pre_w), (h, w)): the canvas the crop is taken from, enlarged
    by 1/sqrt(crop_scale_min) when random_crop is on, and the target."""
    tw, th = cfg.train_img_shape  # reference flag order (W, H)
    target = (th, tw)
    if not cfg.random_crop:
        return target, target
    s = np.sqrt(cfg.crop_scale_min)
    return (int(np.ceil(th / s)), int(np.ceil(tw / s))), target


def draw_augment(gen: torch.Generator, b: int, pre: Tuple[int, int],
                 target: Tuple[int, int], cfg: DataConfig):
    """(tops, lefts, flip) for a batch of ``b``, int32 CPU tensors drawn
    from ``gen``: crop offsets uniform over the canvas (0 when there is
    nothing to crop), flips with probability 1/2 when random_flip is on."""
    zeros = torch.zeros(b, dtype=torch.int32)
    if cfg.random_crop and pre != target:
        tops = torch.randint(0, pre[0] - target[0] + 1, (b,), generator=gen,
                             dtype=torch.int32)
        lefts = torch.randint(0, pre[1] - target[1] + 1, (b,), generator=gen,
                              dtype=torch.int32)
    else:
        tops, lefts = zeros, zeros
    flip = ((torch.rand(b, generator=gen) < 0.5).to(torch.int32)
            if cfg.random_flip else zeros)
    return tops, lefts, flip


def make_train_preprocess(cfg: DataConfig, out_dtype: torch.dtype = torch.float32,
                          with_depth: bool = False) -> Callable:
    """Train preprocess: ``preprocess(batch, tops, lefts, flip) -> (img
    [B,H,W,input_ch] out_dtype, label int32 [B,H,W] or None)``, plus a
    third output with ``with_depth``: the batch's 'depth' in metres,
    float32 [B,H,W], through the same geometry and flip as RGB (the
    multitask trainer's depth target).

    ``batch`` holds the raw planes on one device (uint8 'image' and 'label',
    'depth' or 'hha'; a target batch has no 'label'); ``tops``/``lefts``
    are the crop offsets on the pre-crop canvas and ``flip`` the per-sample
    flags (``draw_augment``). Geometry, as in the JAX package
    (``ops/preprocess.py:214``):

      * the canvas upscales the decode size (every production train
        config): RGB/255 and HHA/255 are sampled bilinearly at the cropped
        canvas positions straight from the decode size (two-tap gathers
        and lerps), labels at the nearest position;
      * otherwise: resize to the canvas (antialiased along a downscaled
        axis), labels nearest, then the crop.

    RGB and HHA stay two float32 tensors, NHWC-contiguous, and go to
    ``fused_normalize_stack`` with the flips; out_dtype rounds once there.
    Labels and depth are flipped with ``torch.where``."""
    pre, target = pre_crop_canvas(cfg)
    _, table, _, _ = get_label_spec(cfg.src_dataset)

    def preprocess(batch: Dict[str, torch.Tensor], tops, lefts, flip):
        image = batch["image"]
        dev = image.device
        label = batch.get("label")
        if label is not None:
            label = remap_labels(label, table)
        rgb = image.to(torch.float32) / 255.0
        extra = _extra_channels(batch, cfg.input_ch, cfg.hha_on_device)
        depth = depth_to_meters(batch["depth"])[..., None] if with_depth else None
        h0, w0 = image.shape[1:3]
        with span("train.draws"):
            tops, lefts = to_device(tops, dev), to_device(lefts, dev)
            flip = to_device(flip, dev, torch.int32)
        if cfg.random_crop and pre != target and pre[0] >= h0 and pre[1] >= w0:
            t_rows = _positions(target[0], h0, pre[0], tops)
            t_cols = _positions(target[1], w0, pre[1], lefts)
            rows, cols = _taps(t_rows, h0), _taps(t_cols, w0)
            rgb = _lerp_axis(_lerp_axis(rgb, rows, 1), cols, 2)
            if extra is not None:
                extra = _lerp_axis(_lerp_axis(extra, rows, 1), cols, 2)
            if depth is not None:
                depth = _lerp_axis(_lerp_axis(depth, rows, 1), cols, 2)
            if label is not None:
                label = _gather_rows(_gather_rows(label, _nearest(t_rows, h0), 1),
                                     _nearest(t_cols, w0), 2)
        else:
            rgb = _crop(resize_bilinear(rgb, pre), tops, lefts, target)
            if extra is not None:
                extra = _crop(resize_bilinear(extra, pre), tops, lefts, target)
            if depth is not None:
                depth = _crop(resize_bilinear(depth, pre), tops, lefts, target)
            if label is not None:
                label = _crop(_resize_nearest_labels(label, pre), tops, lefts, target)
        flipped = (flip > 0)[:, None, None]
        if label is not None:
            label = torch.where(flipped, label.flip(-1), label)
        img = fused_normalize_stack(rgb.contiguous(),
                                    None if extra is None else extra.contiguous(),
                                    flip, cfg.input_ch, out_dtype)
        if depth is None:
            return img, label
        depth = depth[..., 0]
        return img, label, torch.where(flipped, depth.flip(-1), depth)

    return preprocess
