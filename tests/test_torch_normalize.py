"""Port of the fused normalize/stack (mcseg_tpu_torch/ops/normalize.py)
against the JAX Pallas kernel (interpret mode) and its XLA oracle.

On the CPU the wrapper runs the plain version; the CUDA kernel is held
against it in tests/test_torch_cuda.py (skipped without a card) and in
chip_smoke.py. Tolerances: float32 outputs within 1e-6 (same division
formula both sides; the Pallas kernel multiplies by 1/std, which moves the
last bit); bf16 outputs within one bf16 ulp of the float32 result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcseg_tpu.ops.pallas.normalize import (
    fused_normalize_stack as jax_fused,
    reference_normalize_stack as jax_reference,
)
from mcseg_tpu.ops.preprocess import _normalize_stack as jax_normalize_stack
from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

E_CH = {3: 0, 6: 3, 4: 1, 1: 1}


def _inputs(input_ch, seed=0, b=2, h=16, w=32):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    e = E_CH[input_ch]
    extra = rng.rand(b, h, w, e).astype(np.float32) if e else None
    return rgb, extra


def _t(x):
    return None if x is None else torch.from_numpy(x)


# (b, h, w): the base shape, then the CUDA kernel's edge shapes (one sample,
# odd H, a ragged unaligned row and a one-pixel row)
_SHAPES = [((2, 16, 32), "{}"), ((1, 7, 37), "{}-b1h7w37"), ((1, 5, 1), "{}-b1h5w1")]


@pytest.mark.parametrize("input_ch,shape", [
    pytest.param(c, shape, id=fmt.format(c)) for shape, fmt in _SHAPES for c in (3, 6, 4, 1)])
def test_plain_version_matches_jax_kernel_and_oracle(input_ch, shape):
    b, h, w = shape
    rgb, extra = _inputs(input_ch, b=b, h=h, w=w)
    flip = np.array([0, 1] if b == 2 else [1], np.int32)
    got = fused_normalize_stack(_t(rgb), _t(extra), _t(flip), input_ch).numpy()
    jextra = None if extra is None else jnp.asarray(extra)
    pallas = np.asarray(jax_fused(jnp.asarray(rgb), jextra, jnp.asarray(flip),
                                  input_ch=input_ch, interpret=True))
    oracle = np.asarray(jax_reference(jnp.asarray(rgb), jextra, jnp.asarray(flip),
                                      input_ch))
    assert got.shape == (b, h, w, input_ch) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-6)


def test_only_flagged_samples_flip():
    rgb, extra = _inputs(6, seed=1)
    out = fused_normalize_stack(_t(rgb), _t(extra), torch.tensor([0, 1], dtype=torch.int32), 6)
    same = fused_normalize_stack(_t(rgb), _t(extra), torch.zeros(2, dtype=torch.int32), 6)
    np.testing.assert_array_equal(out[0].numpy(), same[0].numpy())
    np.testing.assert_array_equal(out[1].numpy(), same[1].numpy()[:, ::-1, :])


@pytest.mark.parametrize("input_ch", [3, 6])
def test_bf16_output_within_one_ulp(input_ch):
    rgb, extra = _inputs(input_ch, seed=2)
    flip = torch.tensor([1, 0], dtype=torch.int32)
    out = fused_normalize_stack(_t(rgb), _t(extra), flip, input_ch, torch.bfloat16)
    ref32 = fused_normalize_stack(_t(rgb), _t(extra), flip, input_ch).numpy()
    jax_bf16 = np.asarray(jax_fused(
        jnp.asarray(rgb), None if extra is None else jnp.asarray(extra),
        jnp.asarray(flip.numpy()), input_ch=input_ch, out_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    ulp = np.abs(ref32) * 2.0 ** -7  # bf16 keeps 8 significant bits
    assert np.all(np.abs(got - ref32) <= ulp + 1e-30)
    assert np.all(np.abs(got - jax_bf16) <= ulp + 1e-30)


@pytest.mark.parametrize("input_ch", [3, 6])
def test_float_rgb_instance_matches_jax_normalize_stack(input_ch):
    # the resized-geometry eval path: RGB already float in [0, 1]
    rng = np.random.RandomState(3)
    rgb01 = rng.rand(2, 12, 20, 3).astype(np.float32)
    extra = rng.rand(2, 12, 20, 3).astype(np.float32) if input_ch == 6 else None
    got = fused_normalize_stack(_t(rgb01), _t(extra), torch.zeros(2, dtype=torch.int32),
                                input_ch).numpy()
    want = np.asarray(jax_normalize_stack(
        jnp.asarray(rgb01), None if extra is None else jnp.asarray(extra), input_ch))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wrapper_validates_and_cpu_does_not_count():
    rgb, extra = _inputs(6)
    flip = torch.zeros(2, dtype=torch.int32)
    before = fused_normalize_stack.launches
    fused_normalize_stack(_t(rgb), _t(extra), flip, 6)
    assert fused_normalize_stack.launches == before  # plain version: no launch
    with pytest.raises(ValueError):
        fused_normalize_stack(_t(rgb), None, flip, 6)
    with pytest.raises(ValueError):
        fused_normalize_stack(_t(rgb), _t(extra), flip.to(torch.int64), 6)
    with pytest.raises(TypeError):
        fused_normalize_stack(_t(rgb).to(torch.int32), _t(extra), flip, 6)
    with pytest.raises(ValueError):
        fused_normalize_stack(_t(rgb), _t(extra), flip, 5)
