"""Port of the depth -> HHA encoder (mcseg_tpu_torch/ops/hha.py) against
the JAX ``ops/hha.py``, on the synthetic corpus's floor-plus-boxes depth.

Tolerance on the 0-255 HHA scale: 0.01. Disparity and height agree to
float32 rounding; the angle channel is arccos of a normal.gravity dot
product, and arccos near +-1 turns the last-bit differences of the two
frameworks' float32 reductions (the Gram sums behind the eigh, taken in
another order) into ~1e-3 degrees. 0.01 is 1/25 of one uint8 step of the
precomputed-HHA files. The well-conditioned synthetic scene keeps the
gravity eigenproblem far from degenerate and no pixel on a threshold.
"""

import jax.numpy as jnp
import numpy as np
import torch

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.data.datasets import SyntheticShiftedDataset as JaxShifted
from mcseg_tpu.ops import hha as jhha
from mcseg_tpu_torch.ops import hha as thha
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

HHA_ATOL = 0.01


def _depth(n=3, wh=(64, 48)):
    ds = JaxShifted(JaxDataConfig(test_img_shape=wh), "val")
    d = np.stack([ds[i]["depth"] for i in range(n)])
    d[0, :3, :5] = 0.0  # missing pixels
    d[1, 10, 10] = np.nan
    return d


def test_hha_batch_matches_jax():
    d = _depth()
    want = np.asarray(jhha.depth_to_hha_batch(jnp.asarray(d)))
    got = thha.depth_to_hha_batch(torch.from_numpy(d)).numpy()
    assert got.shape == want.shape == (3, 48, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=HHA_ATOL)
    # missing depth is zeroed in every channel, on both sides
    assert np.all(got[0, :3, :5] == 0) and np.all(got[1, 10, 10] == 0)


def test_single_image_form_matches_jax():
    d = _depth(n=2)[1]  # holds a missing pixel
    want = np.asarray(jhha.depth_to_hha(jnp.asarray(d)))
    got = thha.depth_to_hha(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HHA_ATOL)


def test_geometry_stages_match_jax():
    d = _depth(n=2)
    K = jhha.default_intrinsics(48, 64)
    assert tuple(thha.default_intrinsics(48, 64)) == tuple(K)
    valid = np.isfinite(d) & (d > 1e-3)
    dd = np.where(valid, d, 1e3).astype(np.float32)
    for i in range(2):
        jp = jhha._point_cloud(jnp.asarray(dd[i]), K)
        jn = jhha._normals(jp)
        jg = np.asarray(jhha.estimate_gravity(jn, jnp.asarray(valid[i])))
        tp = thha._point_cloud(torch.from_numpy(dd[i : i + 1]), K)
        tn = thha._normals(tp)
        tg = thha.estimate_gravity(tn, torch.from_numpy(valid[i : i + 1]))[0].numpy()
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
        for a, b in zip(jn, tn):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=0, atol=1e-5)
        np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5)
        assert tg[1] > 0.9  # the floor scene's gravity points up


def test_central_diff_edges_one_sided():
    p = torch.arange(20.0).reshape(1, 4, 5) ** 2
    for dim, axis in ((1, 0), (2, 1)):
        want = np.asarray(jhha._central_diff(jnp.asarray(p[0].numpy()), axis))
        np.testing.assert_array_equal(thha._central_diff(p, dim)[0].numpy(), want)
