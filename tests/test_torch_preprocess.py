"""Port of the eval preprocess (mcseg_tpu_torch/ops/preprocess.py) against
the JAX ``make_eval_preprocess`` at identity, upscale and downscale
geometry.

Tolerance on the normalized stack: 2e-3. The RGB planes agree to 1e-6
(same resize semantics, same normalize formula); the HHA planes carry the
encoder's 0.01 bound on the 0-255 scale (tests/test_torch_hha.py), which is
0.01 / 255 / 0.224 = 1.8e-4 after normalization, and a resize mixes
neighbours without growing it. 2e-3 leaves a factor ten for the bilinear
weights' last bits. Labels must be identical.
"""

import numpy as np
import pytest
import torch

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.ops.preprocess import make_eval_preprocess as jax_make_eval_preprocess
from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.datasets import SyntheticShiftedDataset, stack_samples
from mcseg_tpu_torch.ops.preprocess import (
    depth_to_meters,
    make_eval_preprocess,
    remap_labels,
    resize_bilinear,
)
from mcseg_tpu_torch.data.labels import nyu40_raw_to_train_table
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _raw_batch(decode_wh, n=2):
    ds = SyntheticShiftedDataset(DataConfig(test_img_shape=decode_wh), "val")
    return stack_samples(ds, range(n))


@pytest.mark.parametrize("decode_wh,test_wh", [
    ((64, 48), (64, 48)),   # identity: uint8 RGB straight into the kernel
    ((32, 24), (64, 48)),   # upscale: float RGB, two-tap bilinear
    ((80, 60), (64, 48)),   # downscale: float RGB, antialiased bilinear
])
@pytest.mark.parametrize("input_ch", [3, 6])
def test_eval_preprocess_matches_jax(decode_wh, test_wh, input_ch):
    raw = _raw_batch(decode_wh)
    kw = dict(tgt_dataset="synthetic_shifted", test_img_shape=test_wh, input_ch=input_ch)
    want_img, want_lbl = jax_make_eval_preprocess(JaxDataConfig(**kw))(raw)
    got_img, got_lbl = make_eval_preprocess(DataConfig(**kw))(
        {k: torch.from_numpy(v) for k, v in raw.items()})
    assert tuple(got_img.shape) == (2, test_wh[1], test_wh[0], input_ch)
    assert got_img.is_contiguous() and got_img.dtype == torch.float32
    got_img = got_img.numpy()
    want_img = np.asarray(want_img)
    np.testing.assert_allclose(got_img[..., :3], want_img[..., :3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=2e-3)
    assert got_lbl.dtype == torch.int32
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))


def test_resize_semantics_match_jax_image_resize():
    import jax.image
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    for (h, w), (oh, ow) in [((12, 16), (24, 32)), ((24, 32), (12, 16)),
                             ((13, 17), (12, 16)), ((12, 16), (8, 24))]:
        x = rng.rand(2, h, w, 3).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, oh, ow, 3), "bilinear"))
        got = resize_bilinear(torch.from_numpy(x), (oh, ow)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_depth_wire_formats_and_label_remap():
    mm = np.array([[0, 1500, 65535]], np.uint16)
    np.testing.assert_allclose(depth_to_meters(torch.from_numpy(mm)).numpy(),
                               mm.astype(np.float32) * 0.001)
    raw = torch.tensor([[0, 1, 40, 41, 255]], dtype=torch.uint8)
    out = remap_labels(raw, nyu40_raw_to_train_table())
    assert out.dtype == torch.int32
    assert out.tolist() == [[255, 0, 39, 255, 255]]


def test_uint16_depth_gives_same_stack_as_metres():
    raw = _raw_batch((64, 48))
    cfg = DataConfig(tgt_dataset="synthetic_shifted", test_img_shape=(64, 48), input_ch=6)
    pp = make_eval_preprocess(cfg)
    mm = np.round(raw["depth"] * 1000.0).astype(np.uint16)
    base = {k: torch.from_numpy(v) for k, v in raw.items()}
    a, _ = pp({**base, "depth": torch.from_numpy(mm)})
    b, _ = pp({**base, "depth": torch.from_numpy(mm.astype(np.float32) * 0.001)})
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
