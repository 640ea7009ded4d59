"""Eval preprocess on the device: raw planes -> normalized input stack.

The eval half of the JAX package's ``ops/preprocess.py``:

  raw uint8 RGB [B,h,w,3] (+ float metres | uint16 mm depth [B,h,w], or a
  precomputed uint8 HHA plane)
      -> label remap (one gather through the corpus table)
      -> depth -> HHA (ops.hha) when input_ch 6 needs it
      -> bilinear resize to test_img_shape, skipped when the decode size
         already equals it (exact: the resize is then the identity)
      -> fused normalize/stack (ops.normalize, the CUDA kernel on the card)

Labels are remapped but not resized: mIoU is scored at the native label
resolution against logits upsampled by the tester. The train half (random
crop/flip) comes with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
from mcseg_tpu_torch.ops.normalize import fused_normalize_stack


def depth_to_meters(d: torch.Tensor) -> torch.Tensor:
    """Accept both depth wire formats: float32 metres or uint16 millimetres."""
    if d.dtype == torch.uint16:
        return d.to(torch.float32) * 0.001
    return d.to(torch.float32)


def remap_labels(label: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """Raw corpus ids -> train ids (IGNORE where unmapped), int32."""
    lut = torch.as_tensor(np.asarray(table, np.int32), device=label.device)
    return lut[label.long()]


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[B,h,w,C] float -> [B,H,W,C], half-pixel bilinear with the JAX
    ``jax.image.resize`` semantics: antialiased (a widened triangle) along
    a downscaled axis, plain two-tap along an upscaled one."""
    h, w = x.shape[1:3]
    if (h, w) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                      align_corners=False, antialias=hw[0] < h or hw[1] < w)
    return y.permute(0, 2, 3, 1).contiguous()


def _extra_channels(batch: Dict[str, torch.Tensor], input_ch: int,
                    hha_on_device: bool = False) -> Optional[torch.Tensor]:
    """Non-RGB channels in [0, 1]: none for input_ch 3, HHA for 6.

    ``hha_on_device`` picks the HHA source when the batch carries both a
    precomputed 'hha' plane and raw 'depth': True encodes from depth."""
    if input_ch == 3:
        return None
    if input_ch != 6:
        raise ValueError(f"input_ch={input_ch}: the port's preprocess supports 3 and 6")
    has_hha = batch.get("hha") is not None
    has_depth = batch.get("depth") is not None
    if has_hha and not (hha_on_device and has_depth):
        return batch["hha"].to(torch.float32) / 255.0
    if has_depth:
        return depth_to_hha_batch(depth_to_meters(batch["depth"])) / 255.0
    raise ValueError("input_ch=6 needs 'hha' or 'depth' in the batch")


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
