"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a card every test skips (a CUDA kernel has no CPU mode).
Tolerances: float32 output within 1e-6 of the plain version (same IEEE
division formula); bf16 output within half a bf16 ulp of the float32 plain
result (round to nearest).
"""

import numpy as np
import pytest
import torch

from mcseg_tpu_torch.ops.normalize import fused_normalize_stack, normalize_stack_reference

E_CH = {3: 0, 6: 3, 4: 1, 1: 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("input_ch", [3, 6, 4, 1])
@pytest.mark.parametrize("rgb_float", [False, True])
def test_normalize_stack_kernel_matches_plain_version(cuda_device, input_ch, rgb_float):
    rng = np.random.RandomState(4)
    b, h, w = 3, 37, 300  # ragged last W-tile, odd H
    rgb = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)).to(cuda_device)
    if rgb_float:
        rgb = rgb.float() / 255.0
    e = E_CH[input_ch]
    extra = (torch.from_numpy(rng.rand(b, h, w, e).astype(np.float32)).to(cuda_device)
             if e else None)
    flip = torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda_device)
    want = normalize_stack_reference(rgb, extra, flip, input_ch, torch.float32)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fused_normalize_stack.launches
        got = fused_normalize_stack(rgb, extra, flip, input_ch, out_dtype)
        torch.cuda.synchronize()
        assert fused_normalize_stack.launches == before + 1
        assert got.dtype == out_dtype and tuple(got.shape) == (b, h, w, input_ch)
        err = (got.float() - want).abs()
        if out_dtype == torch.float32:
            assert float(err.max()) <= 1e-6
        else:
            assert bool((err <= want.abs() * 2.0 ** -8).all())


@pytest.mark.cuda
def test_normalize_stack_kernel_rejects_non_contiguous(cuda_device):
    rgb = torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda_device)
    extra = torch.zeros((2, 16, 8, 3), device=cuda_device).transpose(1, 2)
    flip = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fused_normalize_stack(rgb, extra, flip, 6)
