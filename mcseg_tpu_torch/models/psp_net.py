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

Under spatial partitioning in training (``parallel/spatial.py``) the convs
and BatchNorms are ``models/drn.py``'s, which exchange halo rows and reduce
over every rank; two places read more than a block's rows:

  * the stem pool takes one row above its block from the neighbour (the
    edge row repeated above the image, which pools as JAX's -inf padding
    does and sends the gradient of a tie back to the edge row);
  * each pyramid bin is a fixed linear map of the /8 map, ``R @ x @ C^T``
    (an exact average, or the resize then the average): each rank applies
    its rows' columns of ``R`` and one differentiable all-reduce over the
    data block's ranks (``parallel.spatial.across_space``) gives the whole
    [B, C, n, n], without gathering the map. The branch after it (1x1 conv,
    BN, resize back) then runs on a tensor every rank of the block holds
    whole. Its BN reduces over every rank like the others, the data
    block's s copies included: equal copies leave the mean and the biased
    variance (which ``BatchNorm2d`` keeps as the running one) those of the
    block's images, and each rank's backward carries its rows' share of the
    gradient, which the all-reduce's backward sums. The resize back runs at
    the whole height and keeps the rank's rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mcseg_tpu_torch.models.drn import Bottleneck, ResStage, _bn, _conv
from mcseg_tpu_torch.ops.upsample import resize_image_nchw
from mcseg_tpu_torch.parallel.mesh import DataParallel, all_sum
from mcseg_tpu_torch.parallel.spatial import RowSplit, across_space, halo_rows


def _axis_weights(size: int, n: int, resized: int, antialias: bool,
                  like: torch.Tensor) -> torch.Tensor:
    """[n, size]: one axis of a pyramid bin, the resize of ``size`` to
    ``resized`` samples (``resize_image_nchw``'s weights, from its own
    kernel on the unit vectors laid along the width: torch's antialiased
    kernel misreads a [.., size, 1] column) followed by the average of each
    ``resized // n`` consecutive samples; computed in at least float32,
    returned in ``like``'s dtype."""
    eye = torch.eye(size, dtype=torch.promote_types(like.dtype, torch.float32),
                    device=like.device)
    resize = eye if resized == size else F.interpolate(
        eye[:, None, None, :], size=(1, resized), mode="bilinear", align_corners=False,
        antialias=antialias)[:, 0, 0, :].T
    k = resized // n
    return resize.reshape(n, k, size).mean(1).to(like.dtype)


def pooled_rows(x: torch.Tensor, n: int, h: int, dp: DataParallel) -> torch.Tensor:
    """The ``n`` x ``n`` bin averages of a [B, C, h, w] map of which ``x``
    is this rank's row block, on every rank of its data block, as
    ``PyramidPooling``'s unsplit pool computes them (differentiable)."""
    rows, w = x.shape[2:]
    exact = h % n == 0 and w % n == 0
    rh, rw = (h, w) if exact else (n * (h // n or 1), n * (w // n or 1))
    antialias = rh < h or rw < w
    r = _axis_weights(h, n, rh, antialias, x).narrow(1, dp.space_rank * rows, rows)
    c = _axis_weights(w, n, rw, antialias, x)
    return all_sum(torch.matmul(torch.matmul(r, x), c.T), across_space(dp))


class PyramidPooling(RowSplit, nn.Module):
    """[B, cin, h, w] -> [B, reduce_ch, h, w]: context at ``bins`` scales,
    fused back at the input's resolution. Under a spatial layout in
    training the input and the output are row blocks."""

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
        dp = self.row_split()
        rows, w = x.shape[2:]
        h = rows if dp is None else rows * dp.space
        outs = [x]
        for i, n in enumerate(self.bins):
            if dp is not None:
                pooled = pooled_rows(x, n, h, dp)
            elif h % n == 0 and w % n == 0:
                pooled = F.avg_pool2d(x, (h // n, w // n))
            else:
                rh, rw = n * (h // n or 1), n * (w // n or 1)
                pooled = F.avg_pool2d(resize_image_nchw(x, rh, rw), (rh // n, rw // n))
            y = getattr(self, f"reduce_bn{i}")(getattr(self, f"reduce{i}")(pooled))
            up = resize_image_nchw(torch.relu(y), h, w)
            outs.append(up if dp is None else up.narrow(2, dp.space_rank * rows, rows))
        return torch.relu(self.fuse_bn(self.fuse(torch.cat(outs, 1))))


def stem_pool(x: torch.Tensor, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """The stem's 3x3/2 max pool padded by one on each side (-inf, as
    ``max_pool2d`` pads). Under ``dp`` (a layout splitting rows) ``x`` is a
    row block starting on an even row: its output rows read one row above
    it, which the neighbour sends (the edge row repeated above the image:
    the same max, and a tie's gradient goes back to the edge row)."""
    if dp is None:
        return F.max_pool2d(x, 3, 2, padding=1)
    return F.max_pool2d(halo_rows(x, dp, 1, 0, replicate=True), 3, 2, padding=(0, 1))


class PSPFeatureGenerator(RowSplit, nn.Module):
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
        x = stem_pool(x, self.row_split())
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return self.ppm(x)
