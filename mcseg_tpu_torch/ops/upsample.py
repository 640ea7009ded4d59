"""Fixed bilinear upsampling of NCHW logits.

Two weight conventions, as in the JAX package:
  * 'resize' — half-pixel centres with edge clamp (``F.interpolate``
    bilinear, ``align_corners=False``);
  * 'convt'  — the classic FCN fixed-bilinear ConvTranspose2d
    (fill_up_weights, k = 2f, stride f, pad f/2), a depthwise transposed
    convolution.

'convt' is the registered ``torch.library`` custom op
``mcseg::upsample_convt``, with its gradient the op
``mcseg::upsample_convt_backward``. On a CUDA tensor each launches its
hand-written kernel in ``csrc/upsample_convt.cu`` (sm_90a, built by nvcc at
first use), which works out its taps from the factor: no weight tensor, no
host-to-card copy. There is no fallback: a CUDA call that cannot launch
raises. On a CPU tensor they run the plain version, ``F.conv_transpose2d``
with the taps of ``bilinear_kernel`` and, for the gradient, ``F.conv2d``
with the same taps. The fake version gives ``torch.export`` the output's
shape, dtype and memory format, so an exported graph holds each op as one
node. The output's memory format is the one ``F.conv_transpose2d`` gives
the input (channels_last for a channels_last input), on both devices.

Under spatial partitioning (``upsample_logits(..., dp=)``, ``dp`` splitting
rows) the input is this rank's row block and so is the output: both modes
read one row of each neighbouring block (``parallel.spatial.halo_rows``),
zeros beyond the image for 'convt' (no input row there), the edge row
repeated for 'resize' (its edge clamp), and keep the block's f x rows.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

from mcseg_tpu_torch.parallel.mesh import DataParallel
from mcseg_tpu_torch.parallel.spatial import halo_rows
from mcseg_tpu_torch.utils.profiler import backward_span, count, span

# the kernels' dtype codes (csrc/upsample_convt.cu)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2, torch.float64: 3}
_CUDA_ERROR_INVALID_VALUE = 1  # what the kernels return for a shape they do not take


def bilinear_kernel(kernel_size: int, dtype=np.float32) -> np.ndarray:
    """The fill_up_weights [k, k] bilinear tap pattern."""
    f = int(np.ceil(kernel_size / 2.0))
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:kernel_size, :kernel_size]
    k = (1 - np.abs(og[0] / f - c)) * (1 - np.abs(og[1] / f - c))
    return k.astype(dtype)


def _taps(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The depthwise weight [C, 1, 2f, 2f] in ``x``'s dtype, on ``x``'s
    device (the CPU, where the op's plain version runs)."""
    k = 2 * factor
    taps = torch.from_numpy(bilinear_kernel(k, np.float64)).to(x.device, x.dtype)
    return taps.expand(x.shape[1], 1, k, k).contiguous()


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    """The memory format a convolution gives for input ``t`` (its weight
    contiguous): channels_last where ``t``'s strides suggest it."""
    return (torch.channels_last if suggest_memory_format(t) == torch.channels_last
            else torch.contiguous_format)


def _output_hw(h: int, w: int, factor: int, pad_h: int, pad_w: int) -> Tuple[int, int]:
    return (h + 1) * factor - 2 * pad_h, (w + 1) * factor - 2 * pad_w


def _input_hw(h: int, w: int, factor: int, pad_h: int, pad_w: int) -> Tuple[int, int]:
    """The input map whose output is [h, w]; raises when there is none."""
    if (h + 2 * pad_h) % factor or (w + 2 * pad_w) % factor:
        raise ValueError(f"no input of the {factor}x convt upsample with padding "
                         f"({pad_h}, {pad_w}) gives a {h}x{w} output")
    return (h + 2 * pad_h) // factor - 1, (w + 2 * pad_w) // factor - 1


def upsample_convt_reference(x: torch.Tensor, factor: int, pad_h: int,
                             pad_w: int) -> torch.Tensor:
    """The plain version of ``mcseg::upsample_convt``: the depthwise
    ``F.conv_transpose2d`` with fill_up_weights."""
    y = F.conv_transpose2d(x, _taps(x, factor), stride=factor, padding=(pad_h, pad_w),
                           groups=x.shape[1])
    return y.contiguous(memory_format=_memory_format(x))


def upsample_convt_backward_reference(grad: torch.Tensor, factor: int, pad_h: int,
                                      pad_w: int) -> torch.Tensor:
    """The plain version of ``mcseg::upsample_convt_backward``: the
    gradient with respect to the input, ``F.conv2d`` with the same taps."""
    gx = F.conv2d(grad, _taps(grad, factor), stride=factor, padding=(pad_h, pad_w),
                  groups=grad.shape[1])
    return gx.contiguous(memory_format=_memory_format(grad))


@torch.library.custom_op("mcseg::upsample_convt", mutates_args=(), device_types="cpu")
def _upsample_convt_op(x: torch.Tensor, factor: int, pad_h: int, pad_w: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return upsample_convt_reference(x, factor, pad_h, pad_w)


@_upsample_convt_op.register_kernel("cuda")
def _upsample_convt_cuda(x, factor, pad_h, pad_w):
    """The op's CUDA implementation: one launch of the forward kernel."""
    return _launch("forward", x, _output_hw(*x.shape[2:], factor, pad_h, pad_w),
                   x.shape[2:], factor, pad_h, pad_w)


@_upsample_convt_op.register_fake
def _upsample_convt_fake(x, factor, pad_h, pad_w):
    b, c, h, w = x.shape
    return torch.empty((b, c, *_output_hw(h, w, factor, pad_h, pad_w)), dtype=x.dtype,
                       device=x.device, memory_format=_memory_format(x))


@torch.library.custom_op("mcseg::upsample_convt_backward", mutates_args=(),
                         device_types="cpu")
def _upsample_convt_backward_op(grad: torch.Tensor, factor: int, pad_h: int,
                                pad_w: int) -> torch.Tensor:
    """The gradient op's CPU implementation: the plain version."""
    _input_hw(*grad.shape[2:], factor, pad_h, pad_w)  # raises where the kernel would
    return upsample_convt_backward_reference(grad, factor, pad_h, pad_w)


@_upsample_convt_backward_op.register_kernel("cuda")
def _upsample_convt_backward_cuda(grad, factor, pad_h, pad_w):
    """The gradient op's CUDA implementation: one launch of the backward
    kernel."""
    hw = _input_hw(*grad.shape[2:], factor, pad_h, pad_w)
    return _launch("backward", grad, hw, hw, factor, pad_h, pad_w)


@_upsample_convt_backward_op.register_fake
def _upsample_convt_backward_fake(grad, factor, pad_h, pad_w):
    b, c, h, w = grad.shape
    return torch.empty((b, c, *_input_hw(h, w, factor, pad_h, pad_w)), dtype=grad.dtype,
                       device=grad.device, memory_format=_memory_format(grad))


def _setup_context(ctx, inputs, output):
    _, ctx.factor, ctx.pad_h, ctx.pad_w = inputs


def _upsample_convt_grad(ctx, grad):
    return _upsample_convt_backward_op(grad, ctx.factor, ctx.pad_h, ctx.pad_w), None, None, None


def _upsample_convt_backward_grad(ctx, grad):  # the adjoint's adjoint: the forward
    return _upsample_convt_op(grad, ctx.factor, ctx.pad_h, ctx.pad_w), None, None, None


_upsample_convt_op.register_autograd(_upsample_convt_grad, setup_context=_setup_context)
_upsample_convt_backward_op.register_autograd(_upsample_convt_backward_grad,
                                              setup_context=_setup_context)


def _launch(direction: str, src: torch.Tensor, out_hw, in_hw, factor: int, pad_h: int,
            pad_w: int) -> torch.Tensor:
    """Launch the ``direction`` kernel on ``src`` (x, or the output's
    gradient) into a new tensor of spatial size ``out_hw``. ``in_hw`` is the
    upsample's input map, the kernels' [Hi, Wi]. A channels_last ``src``
    is [B, H, W, C] to the kernel, a contiguous one [B*C, H, W, 1]; any
    other strides are copied to the format a convolution would give. The
    kernels hold the limits on the factor, the paddings and the channels
    (the backward's staging); a shape past them raises here."""
    if src.dtype not in _DTYPE_CODES:
        raise TypeError(f"upsample_convt takes {sorted(map(str, _DTYPE_CODES))}, "
                        f"got {src.dtype}")
    if min(out_hw) <= 0 or min(in_hw) <= 0:
        raise ValueError(f"upsample_convt: no {factor}x output of a {tuple(in_hw)} map "
                         f"with padding ({pad_h}, {pad_w})")
    fmt = _memory_format(src)
    src = src.contiguous(memory_format=fmt)
    b, c = src.shape[:2]
    out = torch.empty((b, c, *out_hw), dtype=src.dtype, device=src.device, memory_format=fmt)
    if src.numel() == 0:
        return out
    n, ch = (b, c) if fmt == torch.channels_last else (b * c, 1)
    fn = getattr(_library(), f"mcseg_upsample_convt_{direction}")
    with torch.cuda.device(src.device):  # launch on the tensors' card
        err = fn(src.data_ptr(), out.data_ptr(), _DTYPE_CODES[src.dtype], n, *in_hw, ch,
                 factor, pad_h, pad_w, torch.cuda.current_stream(src.device).cuda_stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"the upsample's {direction} kernel does not take [N, H, W, C] "
                         f"{[n, *in_hw, ch]} of {src.dtype} at {factor}x with padding "
                         f"({pad_h}, {pad_w}) (csrc/upsample_convt.cu)")
    if err != 0:
        raise RuntimeError(f"upsample_convt {direction} kernel launch failed: CUDA error {err}")
    if direction == "forward":
        upsample_bilinear_convt.launches += 1
    else:
        upsample_bilinear_convt.backward_launches += 1
    count("upsample_kernel")
    return out


def _library():
    from mcseg_tpu_torch.utils.cuda_build import load

    lib = load("upsample_convt")
    for name in ("mcseg_upsample_convt_forward", "mcseg_upsample_convt_backward"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, i, i, i, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
    return lib


def upsample_bilinear_convt(x: torch.Tensor, factor: int,
                            dp: Optional[DataParallel] = None) -> torch.Tensor:
    """Depthwise ``ConvTranspose2d(C, C, 2f, stride=f, padding=f//2,
    groups=C)`` with fill_up_weights: [B,C,h,w] -> [B,C,f*h,f*w], as the op
    ``mcseg::upsample_convt`` (CUDA tensors launch the kernel:
    ``upsample_bilinear_convt.launches`` and ``.backward_launches`` count
    the forward and backward launches, those of an exported graph too, and
    a profiled run counts each as ``upsample_kernel``). Under ``dp`` ``x``
    is a row block: the output rows of the block need the input rows one
    before and one after it, and a height padding of f/2 + f crops the
    output to exactly its f*h rows. Under autocast a float input is cast
    to the autocast dtype first, as a convolution's is."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev) and x.dtype in (torch.float32, torch.float16,
                                                       torch.bfloat16):
        x = x.to(torch.get_autocast_dtype(dev))
    pad_h = pad_w = factor // 2
    if dp is not None:
        x, pad_h = halo_rows(x, dp, 1, 1), factor // 2 + factor
    return _upsample_convt_op(x, factor, pad_h, pad_w)


upsample_bilinear_convt.launches = 0
upsample_bilinear_convt.backward_launches = 0


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
