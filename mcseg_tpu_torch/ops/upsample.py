"""Fixed bilinear upsampling of NCHW logits.

Two weight conventions, as in the JAX package:
  * 'resize' — half-pixel centres with edge clamp (``F.interpolate``
    bilinear, ``align_corners=False``);
  * 'convt'  — the classic FCN fixed-bilinear ConvTranspose2d
    (fill_up_weights, k = 2f, stride f, pad f/2), run as a depthwise
    ``F.conv_transpose2d``.

Under spatial partitioning (``upsample_logits(..., dp=)``, ``dp`` splitting
rows) the input is this rank's row block and so is the output: both modes
read one row of each neighbouring block (``parallel.spatial.halo_rows``),
zeros beyond the image for 'convt' (no input row there), the edge row
repeated for 'resize' (its edge clamp), and keep the block's f x rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mcseg_tpu_torch.core.device import to_device
from mcseg_tpu_torch.parallel.mesh import DataParallel
from mcseg_tpu_torch.parallel.spatial import halo_rows
from mcseg_tpu_torch.utils.profiler import backward_span, span


def bilinear_kernel(kernel_size: int, dtype=np.float32) -> np.ndarray:
    """The fill_up_weights [k, k] bilinear tap pattern."""
    f = int(np.ceil(kernel_size / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:kernel_size, :kernel_size]
    k = (1 - np.abs(og[0] / f - c)) * (1 - np.abs(og[1] / f - c))
    return k.astype(dtype)


def upsample_bilinear_convt(x: torch.Tensor, factor: int,
                            dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Depthwise ``ConvTranspose2d(C, C, 2f, stride=f, padding=f//2,
    groups=C)`` with fill_up_weights: [B,C,h,w] -> [B,C,f*h,f*w]. Under
    ``dp`` ``x`` is a row block: the output rows of the block need the
    input rows one before and one after it, and a height padding of
    f/2 + f crops the output to exactly its f*h rows."""
    c = x.shape[1]
    k = 2 * factor
    taps = torch.from_numpy(bilinear_kernel(k, np.float64))
    weight = to_device(taps, x.device, x.dtype).expand(c, 1, k, k).contiguous()
    padding = factor // 2
    if dp is not None:
        x, padding = halo_rows(x, dp, 1, 1), (factor // 2 + factor, factor // 2)
    return F.conv_transpose2d(x, weight, stride=factor, padding=padding, groups=c)


def resize_bilinear_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize with edge clamp (two taps, no antialias)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False)


def resize_image_nchw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize with ``jax.image.resize``'s semantics:
    antialiased (a widened triangle) along a downscaled axis, plain two-tap
    along an upscaled one; the identity at the same size."""
    h, w = x.shape[2:]
    if (h, w) == (out_h, out_w):
        return x
    antialias = out_h < h or out_w < w
    if antialias and x.device.type == "cpu" and x.dtype in (torch.bfloat16, torch.float16):
        # the CPU has no reduced-precision antialiased kernel
        return resize_image_nchw(x.float(), out_h, out_w).to(x.dtype)
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                         antialias=antialias)


def upsample_logits(x: torch.Tensor, factor: int, mode: str = "resize",
                    dp: Optional[DataParallel] = None) -> torch.Tensor:
    """``factor`` x bilinear upsample of [B,C,h,w] in ``mode``; under ``dp``
    (a layout splitting rows) ``x`` and the output are row blocks. A
    profiled run marks it as the span ``upsample``, forward and backward,
    whatever computes it."""
    if factor == 1:
        return x
    with span("upsample"):
        out = _upsample(x, factor, mode, dp)
        backward_span("upsample", out, x)
    return out


def _upsample(x: torch.Tensor, factor: int, mode: str,
              dp: Optional[DataParallel]) -> torch.Tensor:
    if mode == "convt":
        return upsample_bilinear_convt(x, factor, dp)
    if mode == "resize":
        h, w = x.shape[2:]
        if dp is None:
            return resize_bilinear_nchw(x, h * factor, w * factor)
        # the half-pixel positions of the block's rows, offset by the one
        # halo row, are those of the whole map: the same taps and weights
        up = resize_bilinear_nchw(halo_rows(x, dp, 1, 1, replicate=True),
                                  (h + 2) * factor, w * factor)
        return up[:, :, factor:factor + h * factor]
    raise ValueError(f"unknown upsample mode {mode!r}")
