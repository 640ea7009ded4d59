"""Plain reference of the models: the DRN trunk (arch D) and the pixel
classifier, in plain PyTorch operations.

DRN is Yu, Koltun and Funkhouser, "Dilated Residual Networks" (CVPR 2017,
arXiv:1705.09914), output stride 8; the pixel classifier is a 1x1 score
conv followed by the fixed bilinear 8x transposed conv of FCN
(``fill_up_weights``). The architecture is read from a configuration file
of the benchmark (``block``, ``layers``, ``channels``), not from
the program's model zoo.

Parameter names follow the program's state dicts (``conv0``, ``bn0``,
``layer1``..``layer8``, ``block{i}``, ``conv{i}``/``bn{i}``,
``proj_conv``/``proj_bn``; ``score`` in the head), so one dict of weights
made by the benchmark loads into both sides.

BatchNorm in training mode normalizes with the biased batch variance and
advances its running variance with the biased variance too (the flax
convention the configuration states), eps 1e-5, momentum 0.1.

Under autograd each residual block and each conv stage is checkpointed:
only its input is kept, and the backward runs its forward again, so that
the reference in float32 fits on the card at the batches the program
trains at. That second forward must leave BatchNorm's running statistics
alone: take gradients inside ``recomputing()``.

Every layer calls ``conv`` for its convolution and ``act`` on each tensor it
hands on (the outputs of convolutions, BatchNorm and residual sums, the
head's scores and logits): ``F.conv2d`` and the identity in the reference,
a rounding pair for the lower-precision control (``reference/quant.py``,
``set_precision``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
UP_FACTOR = 8
UPSAMPLE = "convt"  # the program's name for the heads' fixed bilinear transposed conv
CHECKPOINT = True  # False: autograd keeps every activation and recomputes nothing


def plain_conv(x, w, stride=1, padding=0, dilation=1, groups=1, bias=None):
    return F.conv2d(x, w, bias, stride, padding, dilation, groups)


def identity(x):
    return x


class Precision:
    """The convolution and the rounding of handed-on tensors of a module."""

    conv: Callable = staticmethod(plain_conv)
    act: Callable = staticmethod(identity)


class Conv(Precision, nn.Module):
    """A bias-free conv, symmetric padding ``dilation * (k // 2)``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.stride, self.dilation, self.padding = stride, dilation, dilation * (k // 2)

    def forward(self, x):
        return self.act(self.conv(x, self.weight, self.stride, self.padding, self.dilation))


class BN(Precision, nn.Module):
    track = True  # whether a training-mode forward advances the running statistics

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))
        self.momentum = BN_MOMENTUM

    def forward(self, x):
        if not self.training:
            return self.act(F.batch_norm(x, self.running_mean, self.running_var,
                                         self.weight, self.bias, False, 0.0, BN_EPS))
        if BN.track:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
                self.num_batches_tracked.add_(1)
        return self.act(F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, BN_EPS))


@contextlib.contextmanager
def recomputing():
    """A block in which autograd runs checkpointed forwards again: they do
    not advance BatchNorm's running statistics a second time."""
    BN.track = False
    try:
        yield
    finally:
        BN.track = True


def kept_input(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)``, checkpointed where autograd records it."""
    if CHECKPOINT and torch.is_grad_enabled():
        return checkpoint(module, x, use_reentrant=False, preserve_rng_state=False)
    return module(x)


class ConvStage(nn.Module):
    """n x (3x3 conv, BN, ReLU): levels 1, 2, 7 and 8 of arch D."""

    def __init__(self, cin, features, n, stride=1, dilation=1):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv{i}", Conv(cin if i == 0 else features, features, 3,
                                             stride if i == 0 else 1, dilation))
            self.add_module(f"bn{i}", BN(features))

    def forward(self, x):
        for i in range(self.n):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class BasicBlock(Precision, nn.Module):
    expansion = 1

    def __init__(self, cin, features, stride, dilation):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, dilation[0])
        self.bn1 = BN(features)
        self.conv2 = Conv(features, features, 3, 1, dilation[1])
        self.bn2 = BN(features)
        self.proj = stride != 1 or cin != features
        if self.proj:
            self.proj_conv = Conv(cin, features, 1, stride)
            self.proj_bn = BN(features)

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        skip = self.proj_bn(self.proj_conv(x)) if self.proj else x
        return torch.relu(self.act(y + skip))


class Bottleneck(Precision, nn.Module):
    """1x1, 3x3 (stride and dilation here), 1x1 to 4x the width."""

    expansion = 4

    def __init__(self, cin, features, stride, dilation):
        super().__init__()
        out = features * 4
        self.conv1 = Conv(cin, features, 1)
        self.bn1 = BN(features)
        self.conv2 = Conv(features, features, 3, stride, dilation[1])
        self.bn2 = BN(features)
        self.conv3 = Conv(features, out, 1)
        self.bn3 = BN(out)
        self.proj = stride != 1 or cin != out
        if self.proj:
            self.proj_conv = Conv(cin, out, 1, stride)
            self.proj_bn = BN(out)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        skip = self.proj_bn(self.proj_conv(x)) if self.proj else x
        return torch.relu(self.act(y + skip))


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResStage(nn.Module):
    """``n`` blocks; a dilated level uses its full dilation from the first
    block (levels 5 and 6 of DRN-D)."""

    def __init__(self, block, cin, features, n, stride=1, dilation=1):
        super().__init__()
        self.n = n
        self.out_ch = features * block.expansion
        self.block0 = block(cin, features, stride, (dilation, dilation))
        for i in range(1, n):
            self.add_module(f"block{i}", block(self.out_ch, features, 1, (dilation, dilation)))

    def forward(self, x):
        for i in range(self.n):
            x = kept_input(getattr(self, f"block{i}"), x)
        return x


class DRN(Precision, nn.Module):
    """DRN arch D: [B, input_ch, H, W] -> [B, channels[-1], H/8, W/8]."""

    def __init__(self, block: str, layers: Sequence[int], channels: Sequence[int],
                 input_ch: int):
        super().__init__()
        b, L, ch = BLOCKS[block], layers, channels
        self.conv0 = Conv(input_ch, ch[0], 7)
        self.bn0 = BN(ch[0])
        self.layer1 = ConvStage(ch[0], ch[0], L[0])
        self.layer2 = ConvStage(ch[0], ch[1], L[1], stride=2)
        self.layer3 = ResStage(b, ch[1], ch[2], L[2], stride=2)
        self.layer4 = ResStage(b, self.layer3.out_ch, ch[3], L[3], stride=2)
        self.layer5 = ResStage(b, self.layer4.out_ch, ch[4], L[4], dilation=2)
        self.layer6 = ResStage(b, self.layer5.out_ch, ch[5], L[5], dilation=4)
        self.layer7 = ConvStage(self.layer6.out_ch, ch[6], L[6], dilation=2)
        self.layer8 = ConvStage(ch[6], ch[7], L[7], dilation=1)
        self.out_dim = ch[7]

    def forward(self, x):
        x = torch.relu(self.bn0(self.conv0(self.act(x))))
        for i in range(1, 9):
            layer = getattr(self, f"layer{i}")
            x = kept_input(layer, x) if isinstance(layer, ConvStage) else layer(x)
        return x


def bilinear_taps(k: int) -> np.ndarray:
    """FCN's ``fill_up_weights`` [k, k] pattern."""
    f = int(np.ceil(k / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:k, :k]
    return ((1 - np.abs(og[0] / f - c)) * (1 - np.abs(og[1] / f - c))).astype(np.float64)


def upsample8(x: torch.Tensor) -> torch.Tensor:
    """The fixed bilinear 8x transposed conv, depthwise (k 16, stride 8,
    padding 4): [B,C,h,w] -> [B,C,8h,8w]."""
    c, k = x.shape[1], 2 * UP_FACTOR
    w = torch.from_numpy(bilinear_taps(k)).to(x.device, x.dtype).expand(c, 1, k, k)
    return F.conv_transpose2d(x, w.contiguous(), stride=UP_FACTOR, padding=UP_FACTOR // 2,
                              groups=c)


class PixelClassifier(Precision, nn.Module):
    """1x1 score conv with bias, then the 8x upsample; float32 logits."""

    def __init__(self, cin: int, n_class: int):
        super().__init__()
        self.score = nn.Module()
        self.score.weight = nn.Parameter(torch.empty(n_class, cin, 1, 1))
        self.score.bias = nn.Parameter(torch.zeros(n_class))

    def forward(self, feat):
        scores = self.act(self.conv(feat, self.score.weight, bias=self.score.bias))
        return self.act(upsample8(scores))


def build_models(model: Dict) -> tuple:
    """(G, F1, F2) of a configuration file's model section: DRN arch D and
    two pixel classifiers with the ``convt`` upsample, the only trunk and
    heads the benchmark's configurations run."""
    g = DRN(model["block"], model["layers"], model["channels"], model["input_ch"])
    return g, PixelClassifier(g.out_dim, model["n_class"]), PixelClassifier(
        g.out_dim, model["n_class"])


def set_precision(modules, conv: Callable, act: Callable) -> None:
    """Make ``conv`` the convolution and ``act`` the rounding of every layer
    of ``modules``."""
    for m in modules:
        for sub in m.modules():
            if isinstance(sub, Precision):
                sub.conv, sub.act = conv, act
