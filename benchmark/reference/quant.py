"""The lower-precision control: the reference computed in float8, where the
program computes in bfloat16.

Every tensor that the program holds in bfloat16, the control holds in
float8: the input stack, the outputs of every convolution and BatchNorm,
the residual sums, the heads' scores and logits are rounded to e4m3 on the
way forward (``act``), and the gradient that flows back into each of them
is rounded to e5m2 (the two formats of an fp8 training path). Convolution
weights are rounded to e4m3 where they enter a product (``conv``); the
products are summed in float32. Each rounding scales the tensor so that
its largest magnitude maps to the format's largest finite value (448,
57344), as an fp8 path scales them.

The configurations state bfloat16 compute; float8 is the next precision
below it, so a program that computed in float8 would read like this
control.

``FP8_CONV`` is the narrower step that a program is likelier to take: only
the convolutions in float8 (their inputs and weights rounded to e4m3, the
gradient of each input to e5m2), every other tensor as the reference
holds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.drn import identity

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(fmt).to(x.dtype) * scale


def e4m3(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x: torch.Tensor) -> torch.Tensor:
    return _round(x, torch.float8_e5m2, E5M2_MAX)


class _Activation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return e4m3(x)

    @staticmethod
    def backward(ctx, grad):
        return e5m2(grad)


class _Weight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        return e4m3(w)

    @staticmethod
    def backward(ctx, grad):
        return grad


def fp8_act(x: torch.Tensor) -> torch.Tensor:
    return _Activation.apply(x)


def fp8_conv(x, w, stride=1, padding=0, dilation=1, groups=1, bias=None):
    return F.conv2d(x, _Weight.apply(w), bias, stride, padding, dilation, groups)


def fp8_conv_io(x, w, stride=1, padding=0, dilation=1, groups=1, bias=None):
    return fp8_conv(fp8_act(x), w, stride, padding, dilation, groups, bias)


FP8 = {"conv": fp8_conv, "act": fp8_act}
FP8_CONV = {"conv": fp8_conv_io, "act": identity}
