"""Fused normalize/stack: RGB + extra planes -> normalized channel stack.

``fused_normalize_stack`` is the port of the Pallas TPU kernel
``mcseg_tpu/ops/pallas/normalize.py:84``. On a CUDA tensor it launches the
hand-written kernel ``csrc/normalize_stack.cu`` (sm_90a, built by nvcc at
first use); on a CPU tensor it runs the plain version
``normalize_stack_reference``. There is no fallback between the two: a CUDA
call that cannot launch raises. Both are the implementations of one
registered ``torch.library`` custom op, ``mcseg::normalize_stack``, which
the dispatcher routes by the tensors' device; its fake (meta) version gives
``torch.export`` the output's shape and dtype, so an exported serving graph
holds the op as one node and launches the kernel when it runs. Registering
the op at import builds nothing.

Per sample, where ``flip[b] > 0`` the inputs are mirrored horizontally;
RGB (uint8, or float32 already in [0, 1]) is scaled to [0, 1] and stacked
with the extra planes (HHA/255 for input_ch 6, HHA/255 and the binarized
boundary plane for 7, a depth-like plane for 4; the extra plane alone for
1); each channel becomes (x - mean[c]) / std[c]. The Pallas kernel has no
input_ch 7 instance (it raises); there the function matched is the JAX
package's ``ops/preprocess.py _normalize_stack``.
The output is NHWC-contiguous, i.e. an NCHW tensor in channels_last
memory once permuted.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from mcseg_tpu_torch.data.transforms import HHA_MEAN, HHA_STD, RGB_MEAN, RGB_STD

_EXTRA_CH = {3: 0, 6: 3, 4: 1, 1: 1, 7: 4}


def _build_mean_std(input_ch: int):
    if input_ch == 3:
        mean, std = RGB_MEAN, RGB_STD
    elif input_ch == 6:
        mean = np.concatenate([RGB_MEAN, HHA_MEAN])
        std = np.concatenate([RGB_STD, HHA_STD])
    elif input_ch == 7:  # rgb + hha + boundary
        mean = np.concatenate([RGB_MEAN, HHA_MEAN, [0.5]])
        std = np.concatenate([RGB_STD, HHA_STD, [0.25]])
    elif input_ch == 4:
        mean = np.concatenate([RGB_MEAN, [0.5]])
        std = np.concatenate([RGB_STD, [0.25]])
    elif input_ch == 1:
        mean, std = np.array([0.5], np.float32), np.array([0.25], np.float32)
    else:
        raise ValueError(f"unsupported input_ch {input_ch}")
    return mean.astype(np.float32), std.astype(np.float32)


def normalize_stack_reference(rgb: torch.Tensor, extra01: Optional[torch.Tensor],
                              flip: torch.Tensor, input_ch: int = 3,
                              out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version with the kernel's semantics (a transcription of
    the JAX ``reference_normalize_stack``, plus float RGB in [0, 1])."""
    mean, std = _build_mean_std(input_ch)
    mean = torch.from_numpy(mean).to(rgb.device)
    std = torch.from_numpy(std).to(rgb.device)
    rgb01 = rgb.to(torch.float32) / 255.0 if rgb.dtype == torch.uint8 else rgb
    if input_ch == 3:
        x = rgb01
    elif input_ch == 1:
        x = extra01
    else:
        x = torch.cat([rgb01, extra01], dim=-1)
    x = (x - mean) / std
    fmask = (flip > 0)[:, None, None, None]
    x = torch.where(fmask, x.flip(2), x)
    return x.to(out_dtype).contiguous()


def _check(rgb, extra01, flip, input_ch, out_dtype):
    if input_ch not in _EXTRA_CH:
        raise ValueError(f"unsupported input_ch {input_ch}")
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"rgb must be [B,H,W,3], got {tuple(rgb.shape)}")
    if rgb.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"rgb must be uint8 or float32, got {rgb.dtype}")
    b, h, w, _ = rgb.shape
    e = _EXTRA_CH[input_ch]
    if e:
        if extra01 is None or tuple(extra01.shape) != (b, h, w, e):
            got = None if extra01 is None else tuple(extra01.shape)
            raise ValueError(f"input_ch {input_ch} needs extra01 [B,H,W,{e}] "
                             f"= {(b, h, w, e)}, got {got}")
        if extra01.dtype != torch.float32:
            raise TypeError(f"extra01 must be float32, got {extra01.dtype}")
    elif extra01 is not None and extra01.shape[-1] != 0:
        raise ValueError("input_ch 3 takes no extra planes")
    if tuple(flip.shape) != (b,) or flip.dtype != torch.int32:
        raise ValueError(f"flip must be int32 [{b}], got {flip.dtype} {tuple(flip.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    tensors = [rgb, flip] + ([extra01] if e else [])
    if any(t.device != rgb.device for t in tensors):
        raise ValueError("rgb, extra01 and flip must be on one device")
    return e


@torch.library.custom_op("mcseg::normalize_stack", mutates_args=(), device_types="cpu")
def _normalize_stack_op(rgb: torch.Tensor, extra01: Optional[torch.Tensor],
                        flip: torch.Tensor, input_ch: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return normalize_stack_reference(rgb, extra01, flip, input_ch, out_dtype)


@_normalize_stack_op.register_kernel("cuda")
def _normalize_stack_cuda(rgb, extra01, flip, input_ch, out_dtype):
    """The op's CUDA implementation: one launch of ``csrc/normalize_stack.cu``."""
    tensors = [rgb, flip] + ([extra01] if extra01 is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_normalize_stack needs contiguous inputs")
    b, h, w, _ = rgb.shape
    out = torch.empty((b, h, w, input_ch), dtype=out_dtype, device=rgb.device)
    mean, std = _build_mean_std(input_ch)
    lib = _library()
    with torch.cuda.device(rgb.device):  # launch on the tensors' card
        err = lib.mcseg_normalize_stack(
            rgb.data_ptr(), int(rgb.dtype == torch.float32),
            extra01.data_ptr() if extra01 is not None else None, flip.data_ptr(),
            out.data_ptr(), int(out_dtype == torch.bfloat16), b, h, w, input_ch,
            mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            torch.cuda.current_stream(rgb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalize_stack kernel launch failed: CUDA error {err}")
    fused_normalize_stack.launches += 1
    return out


@_normalize_stack_op.register_fake
def _normalize_stack_fake(rgb, extra01, flip, input_ch, out_dtype):
    b, h, w, _ = rgb.shape
    return rgb.new_empty((b, h, w, input_ch), dtype=out_dtype)


def fused_normalize_stack(rgb: torch.Tensor, extra01: Optional[torch.Tensor],
                          flip: torch.Tensor, input_ch: int = 3,
                          out_dtype=torch.float32) -> torch.Tensor:
    """[B,H,W,3] RGB (+ [B,H,W,E] float extra) -> [B,H,W,input_ch].

    Validates, then calls ``mcseg::normalize_stack``: CUDA tensors launch
    the kernel (``fused_normalize_stack.launches`` counts launches, those
    of an exported graph too); CPU tensors take
    ``normalize_stack_reference``."""
    e = _check(rgb, extra01, flip, input_ch, out_dtype)
    if rgb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {rgb.device}")
    return _normalize_stack_op(rgb, extra01 if e else None, flip, input_ch, out_dtype)


fused_normalize_stack.launches = 0


def _library():
    from mcseg_tpu_torch.utils.cuda_build import load

    lib = load("normalize_stack")
    fn = lib.mcseg_normalize_stack
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_float), p]
        fn.restype = ctypes.c_int
    return lib
