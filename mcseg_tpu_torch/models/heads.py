"""Pixel-classifier head F: 1x1 score conv to n_class at output stride 8,
then a fixed bilinear 8x upsample of the logits (NCHW)."""

from __future__ import annotations

import torch
from torch import nn

from mcseg_tpu_torch.ops.upsample import upsample_logits


class PixelClassifier(nn.Module):
    """Logits come back in at least float32 (bf16 compute is promoted for
    the softmax/argmax that follows; a float64 oracle stays float64)."""

    UP_FACTOR = 8  # the DRN trunk's output stride

    def __init__(self, in_ch: int, n_class: int, upsample: str = "convt"):
        super().__init__()
        self.upsample = upsample
        self.score = nn.Conv2d(in_ch, n_class, 1, bias=True)

    def forward(self, feat):
        x = upsample_logits(self.score(feat), self.UP_FACTOR, self.upsample)
        return x.to(torch.promote_types(x.dtype, torch.float32))
