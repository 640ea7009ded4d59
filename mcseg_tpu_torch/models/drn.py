"""Dilated Residual Networks, arch C and D — the trunk G.

The port of the JAX package's ``models/drn.py`` (Yu, Koltun, Funkhouser,
CVPR 2017), output stride 8:

  * level 0: 7x7 stem;
  * levels 1-2: plain conv stages (arch D) or residual stages (arch C),
    stride 1, then 2;
  * levels 3-4: residual blocks with stride 2;
  * levels 5-6: dilation 2 / 4 instead of stride;
  * levels 7-8: degridding with dilation 2, then 1, without residuals
    (plain conv stages in arch D, residual-free BasicBlocks in arch C).

Blocks are BasicBlocks (two 3x3 convs) or Bottlenecks (1x1, 3x3, 1x1 to 4x
the width). Variants: drn_d_22/38 and drn_c_26/42 (BasicBlock), drn_d_54/105
(Bottleneck), and drn_d_14, a small test trunk.

Submodules are named after the flax parameter tree (``conv0``, ``bn0``,
``layer1``..``layer8``, ``block{i}``, ``conv{i}``/``bn{i}``,
``conv1/bn1/conv2/bn2[/conv3/bn3]/proj_conv/proj_bn``), so JAX weights map
by name (``utils/jax_weights.py``). Padding is symmetric
``dilation * (k // 2)``, BatchNorm eps 1e-5 and momentum 0.1 (torch terms),
its running variance advanced as flax advances it (``BatchNorm2d``). NCHW
in and out. Under spatial partitioning (``parallel/spatial.py``) every conv
of a training-mode forward takes its rows' halo from the neighbouring row
blocks instead of zero padding (``Conv2d``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mcseg_tpu_torch.parallel.mesh import DataParallel
from mcseg_tpu_torch.parallel.spatial import RowSplit, halo_rows
from mcseg_tpu_torch.parallel.sync_bn import sync_batch_norm

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
CHANNELS = (16, 32, 64, 128, 256, 512, 512, 512)  # levels 1-8


class Conv2d(RowSplit, nn.Conv2d):
    """``nn.Conv2d`` that, under a spatial layout in training
    (``set_data_parallel`` with ``space`` > 1), pads its row block's height
    with the ``padding`` rows above and below it from the neighbouring
    blocks (``parallel.spatial.halo_rows``; zeros beyond the image) and its
    width with zeros. A stride-2 conv needs an even start row, which
    ``parallel.spatial.check_spatial`` guarantees."""

    def forward(self, x):
        dp = self.row_split()
        if dp is None:
            return super().forward(x)
        ph, pw = self.padding
        return F.conv2d(halo_rows(x, dp, ph, ph), self.weight, self.bias, self.stride,
                        (0, pw), self.dilation, self.groups)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          dilation: int = 1) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride,
                  padding=dilation * (kernel // 2), dilation=dilation,
                  bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance advances with the *biased*
    batch variance, as flax's BatchNorm does (torch uses the unbiased one).

    The output is torch's own (cuDNN on the card). In training, the running
    variance that torch wrote, ``(1-m)*rv_old + m*var*n/(n-1)``, is rescaled
    in place to ``(1-m)*rv_old + m*var`` with ``n = B*H*W``. The state-dict
    keys are those of ``nn.BatchNorm2d``.

    With a data-parallel context set (``set_data_parallel``), training-mode
    statistics come from the group's global batch
    (``parallel.sync_bn.sync_batch_norm``) and ``n`` is ``world*B*H*W``, as
    GSPMD computes them in the JAX package; eval mode is unchanged."""

    data_parallel: Optional[DataParallel] = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        dp = self.data_parallel
        n = x.numel() // x.shape[1] * (dp.world if dp is not None else 1)
        kept = (1.0 - self.momentum) * self.running_var
        if dp is None:
            y = super().forward(x)
        else:
            self.num_batches_tracked.add_(1)
            y = sync_batch_norm(x, self.weight, self.bias, self.running_mean,
                                self.running_var, self.momentum, self.eps, dp)
        # through .data: the batch_norm node holds running_var for its
        # backward (which does not read it in training) and would refuse a
        # tensor whose version moved
        self.running_var.data.sub_(kept).mul_((n - 1) / n).add_(kept)
        return y


def set_data_parallel(module: nn.Module, dp: Optional[DataParallel]) -> None:
    """Set the data-parallel context of every ``BatchNorm2d`` of ``module``
    (None: statistics of the local batch), and its spatial layout on every
    ``RowSplit`` module (the convs, pools and upsamples that act on row
    blocks) when ``dp`` splits rows."""
    spatial = dp if dp is not None and dp.space > 1 else None
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.data_parallel = dp
        if isinstance(m, RowSplit):
            m.spatial = spatial


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvStage(nn.Module):
    """n x (conv3x3 -> BN -> ReLU); levels 1-2 and 7-8 of arch D."""

    def __init__(self, cin: int, features: int, n_layers: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv{i}", _conv(cin if i == 0 else features, features,
                                              3, stride if i == 0 else 1, dilation))
            self.add_module(f"bn{i}", _bn(features))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = torch.relu(x)
        return x


class BasicBlock(nn.Module):
    """Two 3x3 convs (dilation each its own) + identity or 1x1 projection;
    ``residual=False`` drops the skip (arch C levels 7-8)."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: Tuple[int, int] = (1, 1), residual: bool = True):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, dilation[0])
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, dilation[1])
        self.bn2 = _bn(features)
        self.residual = residual
        self.needs_proj = residual and (stride != 1 or cin != features)
        if self.needs_proj:
            self.proj_conv = _conv(cin, features, 1, stride)
            self.proj_bn = _bn(features)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.residual:
            y = y + (self.proj_bn(self.proj_conv(x)) if self.needs_proj else x)
        return torch.relu(y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 to ``features * 4``, + identity or projection. The
    stride and ``dilation[1]`` sit on the 3x3 ``conv2``; ``dilation[0]`` is
    unused, as in the JAX block."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: Tuple[int, int] = (1, 1), residual: bool = True):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, stride, dilation[1])
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, out, 1)
        self.bn3 = _bn(out)
        self.residual = residual
        self.needs_proj = residual and (stride != 1 or cin != out)
        if self.needs_proj:
            self.proj_conv = _conv(cin, out, 1, stride)
            self.proj_bn = _bn(out)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.residual:
            y = y + (self.proj_bn(self.proj_conv(x)) if self.needs_proj else x)
        return torch.relu(y)


class ResStage(nn.Module):
    """A level of ``block``s. Entering a dilation regime with
    ``new_level=True`` ramps the first conv to half the dilation; levels
    5-8 use ``new_level=False`` (full dilation from the first block)."""

    def __init__(self, block, cin: int, features: int, n_blocks: int,
                 stride: int = 1, dilation: int = 1, new_level: bool = True,
                 residual: bool = True):
        super().__init__()
        self.n_blocks = n_blocks
        self.out_ch = features * block.expansion
        if dilation == 1:
            first_dil = (1, 1)
        else:
            first_dil = (dilation // 2 if new_level else dilation, dilation)
        self.block0 = block(cin, features, stride, first_dil, residual)
        for i in range(1, n_blocks):
            self.add_module(f"block{i}", block(
                self.out_ch, features, 1, (dilation, dilation), residual))

    def forward(self, x):
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


class DRN(nn.Module):
    """DRN trunk: [B, input_ch, H, W] -> [B, 512, H/8, W/8]."""

    def __init__(self, arch: str, block, layers: Sequence[int], input_ch: int = 3):
        super().__init__()
        ch, L = CHANNELS, layers
        self.out_dim = ch[-1]
        self.conv0 = _conv(input_ch, ch[0], 7)
        self.bn0 = _bn(ch[0])
        if arch == "C":
            self.layer1 = ResStage(block, ch[0], ch[0], L[0], stride=1)
            self.layer2 = ResStage(block, self.layer1.out_ch, ch[1], L[1], stride=2)
            c = self.layer2.out_ch
        else:
            self.layer1 = ConvStage(ch[0], ch[0], L[0], stride=1)
            self.layer2 = ConvStage(ch[0], ch[1], L[1], stride=2)
            c = ch[1]
        self.layer3 = ResStage(block, c, ch[2], L[2], stride=2)
        self.layer4 = ResStage(block, self.layer3.out_ch, ch[3], L[3], stride=2)
        self.layer5 = ResStage(block, self.layer4.out_ch, ch[4], L[4], dilation=2,
                               new_level=False)
        self.layer6 = ResStage(block, self.layer5.out_ch, ch[5], L[5], dilation=4,
                               new_level=False)
        c = self.layer6.out_ch
        if arch == "C":
            self.layer7 = ResStage(BasicBlock, c, ch[6], L[6], dilation=2,
                                   new_level=False, residual=False)
            self.layer8 = ResStage(BasicBlock, ch[6], ch[7], L[7], dilation=1,
                                   new_level=False, residual=False)
        else:
            self.layer7 = ConvStage(c, ch[6], L[6], dilation=2)
            self.layer8 = ConvStage(ch[6], ch[7], L[7], dilation=1)

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(x)))
        for i in range(1, 9):
            x = getattr(self, f"layer{i}")(x)
        return x


_DRN_ZOO = {
    # drn_d_14 is not a published variant: one block per residual level,
    # the same stage structure at about half the graph — for cheap tests.
    "drn_d_14": ("D", BasicBlock, (1, 1, 1, 1, 1, 1, 1, 1)),
    "drn_d_22": ("D", BasicBlock, (1, 1, 2, 2, 2, 2, 1, 1)),
    "drn_d_38": ("D", BasicBlock, (1, 1, 3, 4, 6, 3, 1, 1)),
    "drn_d_54": ("D", Bottleneck, (1, 1, 3, 4, 6, 3, 1, 1)),
    "drn_d_105": ("D", Bottleneck, (1, 1, 3, 4, 23, 3, 1, 1)),
    "drn_c_26": ("C", BasicBlock, (1, 1, 2, 2, 2, 2, 1, 1)),
    "drn_c_42": ("C", BasicBlock, (1, 1, 3, 4, 6, 3, 1, 1)),
}


def drn_variants() -> Tuple[str, ...]:
    return tuple(_DRN_ZOO)


def build_drn(net: str, input_ch: int = 3) -> DRN:
    if net not in _DRN_ZOO:
        raise ValueError(f"unknown DRN variant {net!r}; options: {sorted(_DRN_ZOO)}")
    arch, block, layers = _DRN_ZOO[net]
    return DRN(arch, block, layers, input_ch=input_ch)
