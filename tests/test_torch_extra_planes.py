"""The extra input plane of ``input_ch`` 1 and 4 against the JAX package's
``ops/preprocess.py``.

``_extra_channels`` for each source, in JAX's order of preference: depth
over the largest depth of the whole batch (metres, and uint16 millimetres),
the HHA disparity plane / 255, 'ir' / 255, 'boundary' > 0. Then the eval
preprocess (identity and resized geometry) and the train preprocess (the
upscale and resize-then-crop geometries, crop off, with JAX's own draws
injected) for input_ch 1 and 4 on the synthetic corpus, whose plane is
depth.

Bounds: ``_extra_channels`` equal to float32 rounding (1e-7: one division
per value on each side). Labels bit-equal. Images in float32 within 1e-5
for every channel (the port samples with gathers and lerps, JAX with
interpolation matmuls: measured ~1e-6 on RGB in
``tests/test_torch_train_preprocess.py``); in bfloat16 within 0.08, as
that file states for its bf16 case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.ops.preprocess import _extra_channels as jax_extra_channels
from mcseg_tpu.ops.preprocess import make_eval_preprocess as jax_make_eval_preprocess
from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.ops.preprocess import _extra_channels, make_eval_preprocess
from test_torch_train_preprocess import GEOMETRIES, _raw, _run_both
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

ATOL = 1e-5
BF16_ATOL = 0.08


def _sources(rng, b=3, h=10, w=12):
    depth_m = rng.uniform(0.5, 6.0, (b, h, w)).astype(np.float32)
    depth_m[1] *= 0.5  # the batch maximum lies in another sample than sample 1's
    return {
        "depth": {"depth": depth_m},
        "depth_mm": {"depth": (depth_m * 1000).astype(np.uint16)},
        "hha": {"hha": rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)},
        "ir": {"ir": rng.randint(0, 256, (b, h, w)).astype(np.uint8)},
        "boundary": {"boundary": (rng.rand(b, h, w) < 0.3).astype(np.uint8) * 255},
    }


@pytest.mark.parametrize("input_ch", [1, 4])
@pytest.mark.parametrize("source", ["depth", "depth_mm", "hha", "ir", "boundary"])
def test_extra_channels_each_source_matches_jax(source, input_ch):
    rng = np.random.RandomState(20)
    planes = _sources(rng)[source]
    batch = {"image": rng.randint(0, 256, (3, 10, 12, 3)).astype(np.uint8), **planes}
    want = np.asarray(jax_extra_channels({k: jnp.asarray(v) for k, v in batch.items()},
                                         input_ch))
    got = _extra_channels({k: torch.as_tensor(v) for k, v in batch.items()}, input_ch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 10, 12, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    if source == "depth":  # one maximum over the whole batch, not per sample
        assert got[1].max() < 0.99 and abs(float(got.max()) - 1.0) < 1e-7


def test_extra_channels_preference_and_refusals():
    rng = np.random.RandomState(21)
    s = _sources(rng)
    both = {**s["depth"], **s["hha"], **s["ir"]}
    np.testing.assert_array_equal(_extra_channels({k: torch.as_tensor(v) for k, v in both.items()}, 4),
                                  _extra_channels({"depth": torch.as_tensor(s["depth"]["depth"])}, 4))
    with pytest.raises(ValueError, match="needs 'depth', 'hha', 'ir' or 'boundary'"):
        _extra_channels({"image": torch.zeros(1, 2, 2, 3)}, 4)
    # input_ch 7: the precomputed HHA planes and the binarized boundary, as JAX's
    seven = {**s["hha"], **s["boundary"]}
    want = np.asarray(jax_extra_channels({k: jnp.asarray(v) for k, v in seven.items()}, 7))
    got = _extra_channels({k: torch.as_tensor(v) for k, v in seven.items()}, 7)
    assert tuple(got.shape) == want.shape == (3, 10, 12, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0)
    with pytest.raises(ValueError, match="input_ch=7 needs 'boundary'"):
        _extra_channels({"hha": torch.zeros(1, 2, 2, 3)}, 7)


@pytest.mark.parametrize("input_ch", [1, 4])
@pytest.mark.parametrize("decode_wh,test_wh", [((64, 48), (64, 48)), ((96, 72), (64, 48))])
def test_eval_preprocess_depth_plane_matches_jax(decode_wh, test_wh, input_ch):
    raw = _raw(decode_wh, 2)
    kw = dict(tgt_dataset="synthetic", test_img_shape=test_wh, input_ch=input_ch)
    want_img, want_lbl = jax_make_eval_preprocess(JaxDataConfig(**kw))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    got_img, got_lbl = make_eval_preprocess(DataConfig(**kw))(
        {k: torch.as_tensor(v) for k, v in raw.items()})
    assert tuple(got_img.shape) == (2, test_wh[1], test_wh[0], input_ch)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=ATOL)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("input_ch", [1, 4])
def test_train_preprocess_depth_plane_matches_jax(geometry, input_ch):
    decode, shape, crop = GEOMETRIES[geometry]
    raw = _raw(decode, 3)
    want_img, want_lbl, got_img, got_lbl, draws = _run_both(
        dict(train_img_shape=shape, input_ch=input_ch, random_crop=crop, random_flip=True),
        raw, jax.random.key(17))
    assert got_img.shape == want_img.shape == (3, 48, 64, input_ch)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=ATOL)
    assert 0 < int(draws[2].sum()) < 3  # a mixed flip pattern


@pytest.mark.parametrize("input_ch", [1, 4])
def test_train_preprocess_depth_plane_bf16(input_ch):
    raw = _raw((64, 48), 3)
    want_img, want_lbl, got_img, got_lbl, _ = _run_both(
        dict(train_img_shape=(64, 48), input_ch=input_ch), raw, jax.random.key(18),
        compute_dtype=jnp.bfloat16, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=BF16_ATOL)
