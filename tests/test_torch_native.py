"""The port's native decoder (``mcseg_tpu_torch/native``) against the JAX
package's (``mcseg_tpu/native``) on the same files.

Both libraries are built here from their own copies of ``decoder.cpp``
with g++ against libpng and libjpeg, so every decode is bit-equal: PNG RGB,
gray and paletted labels, 8- and 16-bit depth, bilinear and nearest
resizes, JPEG, and the threaded batch API. A missing file raises IOError on
both. JPEG also stays within JAX's own tolerance of PIL (2 levels,
``tests/test_native_decoder.py``). The files are written with PIL.
"""

import numpy as np
import pytest
from PIL import Image

from mcseg_tpu import native as jax_native
from mcseg_tpu_torch import native
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    if not (native.available() and jax_native.available()):
        pytest.skip(f"native decoder unavailable here: {native.build_report()}")
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (48, 64, 3), np.uint8)
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(rgb).save(d / "rgb.jpg", quality=95)
    lbl = rng.randint(0, 40, (48, 64)).astype(np.uint8)
    Image.fromarray(lbl).save(d / "label.png")
    Image.fromarray((rng.rand(48, 64) * 4000).astype(np.uint16)).save(d / "depth16.png")
    Image.fromarray(rng.randint(0, 255, (48, 64), np.uint8)).save(d / "depth8.png")
    pal = Image.fromarray(lbl, mode="P")
    palette = np.zeros((256, 3), np.uint8)
    palette[:40] = rng.randint(0, 255, (40, 3))
    pal.putpalette(palette.flatten().tolist())
    pal.save(d / "label_paletted.png")
    return d


# (decode function name, file, output (h, w)): native size and resizes
CASES = [
    ("decode_rgb", "rgb.png", (48, 64)),
    ("decode_rgb", "rgb.png", (96, 128)),
    ("decode_rgb", "rgb.png", (30, 40)),
    ("decode_rgb", "rgb.jpg", (48, 64)),
    ("decode_rgb", "label.png", (48, 64)),  # gray replicated to RGB
    ("decode_gray", "label.png", (48, 64)),
    ("decode_gray", "label.png", (24, 32)),
    ("decode_gray", "label_paletted.png", (48, 64)),
    ("decode_gray", "label_paletted.png", (100, 90)),
    ("decode_depth16", "depth16.png", (48, 64)),
    ("decode_depth16", "depth16.png", (480, 640)),
    ("decode_depth16", "depth8.png", (48, 64)),
]


@pytest.mark.parametrize("fn,name,hw", CASES, ids=lambda v: str(v))
def test_decode_bit_equal_to_jax(img_dir, fn, name, hw):
    path = str(img_dir / name)
    got = getattr(native, fn)(path, *hw)
    want = getattr(jax_native, fn)(path, *hw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn,names", [
    ("decode_rgb_batch", ["rgb.png", "rgb.jpg", "label.png"] * 2),
    ("decode_gray_batch", ["label.png", "label_paletted.png"] * 3),
    ("decode_depth16_batch", ["depth16.png", "depth8.png"] * 3),
])
def test_batch_api_bit_equal_to_jax(img_dir, fn, names):
    paths = [str(img_dir / n) for n in names]
    got = getattr(native, fn)(paths, 40, 50, n_threads=3)
    np.testing.assert_array_equal(got, getattr(jax_native, fn)(paths, 40, 50, n_threads=3))
    single = fn.replace("_batch", "")
    for k, p in enumerate(paths):  # the pool decodes as one call per file
        np.testing.assert_array_equal(got[k], getattr(native, single)(p, 40, 50))


def test_exact_planes_and_jpeg_tolerance(img_dir):
    rgb = np.asarray(Image.open(img_dir / "rgb.png"))
    np.testing.assert_array_equal(native.decode_rgb(str(img_dir / "rgb.png"), 48, 64), rgb)
    pil_idx = np.asarray(Image.open(img_dir / "label_paletted.png"), np.uint8)
    np.testing.assert_array_equal(
        native.decode_gray(str(img_dir / "label_paletted.png"), 48, 64), pil_idx)
    depth = np.asarray(Image.open(img_dir / "depth16.png")).astype(np.float32) / 1000.0
    np.testing.assert_allclose(native.decode_depth16(str(img_dir / "depth16.png"), 48, 64),
                               depth, atol=1e-6)
    jpg = np.asarray(Image.open(img_dir / "rgb.jpg").convert("RGB")).astype(int)
    assert np.abs(native.decode_rgb(str(img_dir / "rgb.jpg"), 48, 64).astype(int) - jpg).max() <= 2


def test_missing_file_and_bad_batch_raise(img_dir):
    for mod in (native, jax_native):
        with pytest.raises(IOError):
            mod.decode_rgb(str(img_dir / "nope.png"), 8, 8)
        with pytest.raises(IOError):
            mod.decode_gray_batch([str(img_dir / "label.png"), str(img_dir / "nope.png")], 8, 8)


def test_library_is_built_under_build_native(img_dir):
    report = native.build_report()
    assert report["built"] and report["error"] is None
    assert "/build/native/libmcseg_decoder-" in report["path"]
