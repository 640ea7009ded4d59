"""The port's train preprocess against ``make_train_preprocess`` of the JAX
package, with the same random draws on both sides.

The JAX side draws its crop offsets and flips from its key; the test draws
them with ``jax.random`` exactly as ``mcseg_tpu/ops/preprocess.py:214``
does and hands the same values to the port's ``preprocess(batch, tops,
lefts, flip)``. Cases: the upscale geometry (the canvas is larger than the
decode size: every production train config), the resize-then-crop
geometry (decode larger than the canvas), random_crop off, flips on and
off, input_ch 3 and 6 (HHA from raw depth).

Bounds. Labels are bit-equal. float32 images: the port samples with
gathers and lerps, JAX with interpolation matmuls; 1e-5 holds the RGB
channels (measured 1.2e-6). The HHA channels get 2e-3 (0.115 on the 0-255
HHA scale): on the floor, where a pixel's normal is parallel to gravity,
the angle is arccos of a float32 cosine within a few steps of 1, and one
step there moves it by up to 0.02 degrees (the 96x72 decode has 30 pixels
at 0.028 and 0.034 degrees, i.e. 2 and 3 steps). The two encoders sum in
different orders, so such pixels differ by a few steps: measured 6.5e-5,
and 7.4e-4 (0.043 degrees) in one run on another worker. bfloat16: JAX
resizes and normalizes in bf16, the port resizes in float32 and rounds
once in the kernel, so the two differ by a few bf16 steps of values up to
2.7 (one step is 2^-6 = 0.0156 there): bound 0.08 (5 steps), measured
0.047 (3 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_train_draws as _jax_draws
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.ops.preprocess import make_train_preprocess as jax_make_train_preprocess
from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
from mcseg_tpu_torch.ops.preprocess import (
    draw_augment, make_train_preprocess, pre_crop_canvas)
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

RGB_ATOL = 1e-5
HHA_ATOL = 2e-3
BF16_ATOL = 0.08


def _raw(decode_wh, n, seed=0):
    cfg = DataConfig(train_img_shape=decode_wh, max_samples=n)
    ds = get_dataset("synthetic", cfg, "train")
    return stack_samples(ds, range(seed, seed + n))


def _run_both(cfg_kw, raw, key, compute_dtype=jnp.float32, out_dtype=torch.float32):
    jcfg = JaxDataConfig(src_dataset="synthetic", **cfg_kw)
    pcfg = DataConfig.from_dict(jcfg.to_dict())
    b = raw["image"].shape[0]
    pre, target = pre_crop_canvas(pcfg)
    want_img, want_lbl = jax.jit(jax_make_train_preprocess(jcfg, compute_dtype=compute_dtype))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    draws = _jax_draws(key, b, pre, target, pcfg.random_crop, pcfg.random_flip)
    got_img, got_lbl = make_train_preprocess(pcfg, out_dtype)(
        {k: torch.as_tensor(v) for k, v in raw.items()}, *draws)
    return (np.asarray(want_img.astype(jnp.float32)), np.asarray(want_lbl),
            got_img.float().numpy(), got_lbl.numpy(), draws)


GEOMETRIES = {
    # (decode W, H), train_img_shape, random_crop: canvas 58x77 > 48x64 decode
    "upscale": ((64, 48), (64, 48), True),
    # decode 96x72 > canvas 58x77: antialiased resize, then the crop
    "resize_then_crop": ((96, 72), (64, 48), True),
    "no_crop": ((96, 72), (64, 48), False),
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("input_ch", [3, 6])
@pytest.mark.parametrize("random_flip", [True, False])
def test_train_preprocess_matches_jax_fp32(geometry, input_ch, random_flip):
    decode, shape, crop = GEOMETRIES[geometry]
    raw = _raw(decode, 3)
    want_img, want_lbl, got_img, got_lbl, draws = _run_both(
        dict(train_img_shape=shape, input_ch=input_ch, random_crop=crop,
             random_flip=random_flip, hha_on_device=True),
        raw, jax.random.key(11))
    assert got_img.shape == want_img.shape == (3, 48, 64, input_ch)
    assert got_lbl.dtype == np.int32 and got_lbl.shape == (3, 48, 64)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    np.testing.assert_allclose(got_img[..., :3], want_img[..., :3], rtol=0, atol=RGB_ATOL)
    np.testing.assert_allclose(got_img[..., 3:], want_img[..., 3:], rtol=0, atol=HHA_ATOL)
    if random_flip:
        assert 0 < int(draws[2].sum()) < 3  # the key gives a mixed flip pattern


@pytest.mark.parametrize("geometry", ["upscale", "resize_then_crop"])
def test_train_labels_bit_equal_over_many_offsets(geometry):
    """Nearest sampling of labels at 16 draws x 8 samples of crop offsets;
    t is float32 in JAX's order of operations, so no index lands on the
    other side of a near-tie."""
    decode = (160, 120) if geometry == "upscale" else (240, 180)
    raw = _raw(decode, 8, seed=3)
    jcfg = JaxDataConfig(src_dataset="synthetic", train_img_shape=(160, 120), input_ch=3)
    pcfg = DataConfig.from_dict(jcfg.to_dict())
    pre, target = pre_crop_canvas(pcfg)
    assert pre == (144, 192)
    jpp = jax.jit(jax_make_train_preprocess(jcfg))
    pp = make_train_preprocess(pcfg)
    jraw = {k: jnp.asarray(v) for k, v in raw.items()}
    traw = {k: torch.as_tensor(v) for k, v in raw.items()}
    for i in range(16):
        key = jax.random.key(100 + i)
        _, want = jpp(jraw, key)
        _, got = pp(traw, *_jax_draws(key, 8, pre, target, True, True))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"draw {i}")


def test_train_preprocess_bf16_within_bound():
    raw = _raw((64, 48), 3)
    want_img, want_lbl, got_img, got_lbl, _ = _run_both(
        dict(train_img_shape=(64, 48), input_ch=6, hha_on_device=True), raw,
        jax.random.key(11), compute_dtype=jnp.bfloat16, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got_lbl, want_lbl)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=BF16_ATOL)


def test_target_batch_without_label_and_draws():
    cfg = DataConfig(train_img_shape=(64, 48), input_ch=6)
    pre, target = pre_crop_canvas(cfg)
    assert pre == (58, 77) and target == (48, 64)
    raw = _raw((64, 48), 4)
    batch = {k: torch.as_tensor(v) for k, v in raw.items() if k != "label"}
    gen = torch.Generator().manual_seed(0)
    tops, lefts, flip = draw_augment(gen, 4, pre, target, cfg)
    for t, hi in ((tops, 10), (lefts, 13), (flip, 1)):
        assert t.dtype == torch.int32 and t.shape == (4,)
        assert 0 <= int(t.min()) and int(t.max()) <= hi
    img, label = make_train_preprocess(cfg)(batch, tops, lefts, flip)
    assert label is None and tuple(img.shape) == (4, 48, 64, 6)
    off = dataclasses.replace(cfg, random_crop=False, random_flip=False)
    assert pre_crop_canvas(off) == (target, target)
    assert all(int(t.abs().sum()) == 0 for t in draw_augment(gen, 4, target, target, off))
