"""Heads on the trunk's stride-8 features (NCHW): the pixel classifier F
(1x1 score conv to n_class) and the multitask trainer's two auxiliary heads
(1x1 conv to one channel: boundary logits, depth in metres), each followed
by the same fixed bilinear 8x upsample. Under spatial partitioning in
training the features and the output are row blocks
(``ops.upsample.upsample_logits(dp=)``)."""

from __future__ import annotations

import torch
from torch import nn

from mcseg_tpu_torch.ops.upsample import upsample_logits
from mcseg_tpu_torch.parallel.spatial import RowSplit

UP_FACTOR = 8  # the DRN trunk's output stride


class PixelClassifier(RowSplit, nn.Module):
    """Logits come back in at least float32 (bf16 compute is promoted for
    the softmax/argmax that follows; a float64 oracle stays float64)."""

    def __init__(self, in_ch: int, n_class: int, upsample: str = "convt"):
        super().__init__()
        self.upsample = upsample
        self.score = nn.Conv2d(in_ch, n_class, 1, bias=True)

    def forward(self, feat):
        x = upsample_logits(self.score(feat), UP_FACTOR, self.upsample, self.row_split())
        return x.to(torch.promote_types(x.dtype, torch.float32))


class _OneChannelHead(RowSplit, nn.Module):
    """1x1 conv to one channel + 8x upsample, at least float32 out. The conv
    is named as in the flax tree ('boundary' or 'depth'), so the state dict
    maps to the JAX subtree 'B' or 'D' one to one."""

    CONV_NAME = ""

    def __init__(self, in_ch: int, upsample: str = "convt"):
        super().__init__()
        self.upsample = upsample
        self.add_module(self.CONV_NAME, nn.Conv2d(in_ch, 1, 1, bias=True))

    @property
    def conv(self) -> nn.Conv2d:
        return getattr(self, self.CONV_NAME)

    def forward(self, feat):
        x = upsample_logits(self.conv(feat), UP_FACTOR, self.upsample, self.row_split())
        return x.to(torch.promote_types(x.dtype, torch.float32))


class BoundaryDetector(_OneChannelHead):
    """Boundary logits [B,1,H,W]; trained with ``losses.seg.balanced_bce_2d``
    against ``boundary_targets_from_labels`` of the source labels."""

    CONV_NAME = "boundary"


class DepthRegressor(_OneChannelHead):
    """Depth in metres [B,1,H,W]; trained with ``losses.seg.berhu_loss``."""

    CONV_NAME = "depth"
