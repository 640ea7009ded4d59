"""PSPNet trunk (``--net psp``, also ``psp_net`` / ``pspnet``).

The port of the JAX package's ``models/psp_net.py`` (Zhao et al., CVPR
2017): a dilated ResNet-50 at output stride 8 followed by the Pyramid
Pooling Module, 512 channels out. F is the DRN ``PixelClassifier``.

  * stem: 7x7/2 conv (padding 3, no bias) -> BN -> ReLU -> 3x3/2 max pool
    padded (1, 1) on both sides;
  * stages of ``models/drn.py`` Bottlenecks: 64 x3, 128 x4 (stride 2),
    256 x6 at dilation 2 and 512 x3 at dilation 4, both at full dilation
    from the first block;
  * PPM: per bin count n in 1/2/3/6 an average pool to n x n (exact when n
    divides both sides; otherwise a resize to the nearest multiples of n,
    at least n, then the pool), a 1x1 conv to 128, BN, ReLU and a resize
    back to h x w; the four and the input concatenated, a 3x3 ``fuse`` to
    512, ``fuse_bn``, ReLU.

Every resize has ``jax.image.resize``'s bilinear semantics
(``ops.upsample.resize_image_nchw``: antialiased where it shrinks).
Submodules are named after the flax tree, so ``utils/jax_weights.py``
maps JAX weights by name. NCHW in and out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mcseg_tpu_torch.models.drn import Bottleneck, ResStage, _bn, _conv
from mcseg_tpu_torch.ops.upsample import resize_image_nchw


class PyramidPooling(nn.Module):
    """[B, cin, h, w] -> [B, reduce_ch, h, w]: context at ``bins`` scales,
    fused back at the input's resolution."""

    def __init__(self, cin: int, bins: Sequence[int] = (1, 2, 3, 6), reduce_ch: int = 512):
        super().__init__()
        self.bins = tuple(bins)
        per_bin = reduce_ch // len(self.bins)
        for i in range(len(self.bins)):
            self.add_module(f"reduce{i}", _conv(cin, per_bin, 1))
            self.add_module(f"reduce_bn{i}", _bn(per_bin))
        self.fuse = _conv(cin + per_bin * len(self.bins), reduce_ch, 3)
        self.fuse_bn = _bn(reduce_ch)

    def forward(self, x):
        h, w = x.shape[2:]
        outs = [x]
        for i, n in enumerate(self.bins):
            if h % n == 0 and w % n == 0:
                pooled = F.avg_pool2d(x, (h // n, w // n))
            else:
                rh, rw = n * (h // n or 1), n * (w // n or 1)
                pooled = F.avg_pool2d(resize_image_nchw(x, rh, rw), (rh // n, rw // n))
            y = getattr(self, f"reduce_bn{i}")(getattr(self, f"reduce{i}")(pooled))
            outs.append(resize_image_nchw(torch.relu(y), h, w))
        return torch.relu(self.fuse_bn(self.fuse(torch.cat(outs, 1))))


class PSPFeatureGenerator(nn.Module):
    """Dilated ResNet-50 + PPM: [B, input_ch, H, W] -> [B, 512, H/8, W/8]."""

    out_dim = 512

    def __init__(self, input_ch: int = 3):
        super().__init__()
        self.conv0 = _conv(input_ch, 64, 7, 2)
        self.bn0 = _bn(64)
        self.layer1 = ResStage(Bottleneck, 64, 64, 3, stride=1)
        self.layer2 = ResStage(Bottleneck, self.layer1.out_ch, 128, 4, stride=2)
        self.layer3 = ResStage(Bottleneck, self.layer2.out_ch, 256, 6, dilation=2,
                               new_level=False)
        self.layer4 = ResStage(Bottleneck, self.layer3.out_ch, 512, 3, dilation=4,
                               new_level=False)
        self.ppm = PyramidPooling(self.layer4.out_ch, reduce_ch=self.out_dim)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.ppm(x)
