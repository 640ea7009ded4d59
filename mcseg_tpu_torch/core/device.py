"""Device and compute-dtype policy shared by the entry points."""

from __future__ import annotations

import contextlib

import torch

from mcseg_tpu_torch.utils.profiler import count_copy, span

_DTYPES = {"bfloat16": torch.bfloat16, "float64": torch.float64}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this process has none (entry points never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def to_device(t: torch.Tensor, device, dtype=None, non_blocking: bool = False
              ) -> torch.Tensor:
    """``t.to(device, dtype, non_blocking)``: every host-to-card copy of the
    program goes through here, so that a profiled run counts its bytes and
    the copies the host waits for (``utils.profiler.count_copy``), and
    marks each of the latter as the span ``host_wait``."""
    if _host_to_card(t, device) and count_copy(t, non_blocking, dtype):
        with span("host_wait"):
            return t.to(device=device, dtype=dtype, non_blocking=non_blocking)
    return t.to(device=device, dtype=dtype, non_blocking=non_blocking)


def _host_to_card(t: torch.Tensor, device) -> bool:
    return t.device.type == "cpu" and torch.device(device).type != "cpu"


def compute_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype -> activation dtype. bfloat16 on the card;
    float64 exists as a CPU test oracle; anything else is float32."""
    return _DTYPES.get(name, torch.float32)


def compute_context(dtype: torch.dtype, device: torch.device):
    """Context for the trunk and heads: bf16 activations through autocast
    (parameters and BatchNorm statistics stay float32, as in the JAX
    models), nothing for float32/float64, where the modules themselves
    hold the dtype."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.autocast(device_type=device.type, dtype=dtype)
    return contextlib.nullcontext()
