"""The port's corpus-preparation tools against the JAX package's, on the
same inputs.

``prepare_boundary``: the edge rule bit-equal to JAX's
``labels_to_boundary`` and to the boundary head's targets
(``losses/seg.py``), and the tools' files equal after decoding.
``prepare_hha``: the port's files are its own encoder's planes, and within
one level of JAX's (the two encoders agree within 0.01 on the 0-255 scale,
``tests/test_torch_hha.py``, and the files truncate to integers).
``organize_suncg`` and ``prepare_nyu``: the same trees, file for file,
equal after decoding. The port's tools write PNGs with the standard-library
encoder.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mcseg_tpu.tools import organize_suncg as jax_organize_suncg
from mcseg_tpu.tools import prepare_boundary as jax_prepare_boundary
from mcseg_tpu.tools import prepare_hha as jax_prepare_hha
from mcseg_tpu.tools import prepare_nyu as jax_prepare_nyu
from mcseg_tpu_torch.losses.seg import boundary_targets_from_labels
from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
from mcseg_tpu_torch.tools import organize_suncg, prepare_boundary, prepare_hha, prepare_nyu
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _tree(root):
    """{relative path: decoded pixels} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


def _assert_trees_equal(got, want):
    got, want = _tree(got), _tree(want)
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dilate", [0, 2])
def test_prepare_boundary_matches_jax(tmp_path, dilate):
    rng = np.random.RandomState(dilate)
    labels = tmp_path / "labels"
    labels.mkdir()
    for i in range(3):
        lbl = np.repeat(np.repeat(rng.randint(0, 5, (6, 8)), 4, 0), 4, 1).astype(np.uint8)
        lbl[:3, :5] = 255  # ignored
        Image.fromarray(lbl).save(labels / f"{i:03d}.png")
        got = prepare_boundary.labels_to_boundary(lbl, 255, dilate)
        np.testing.assert_array_equal(got, jax_prepare_boundary.labels_to_boundary(lbl, 255, dilate))
        if dilate == 0:
            tgt, _ = boundary_targets_from_labels(torch.from_numpy(lbl)[None].long())
            np.testing.assert_array_equal(got > 0, tgt[0].numpy() > 0.5)
    args = [str(labels)] + (["--dilate", str(dilate)] if dilate else [])
    prepare_boundary.main(args[:1] + [str(tmp_path / "port")] + args[1:])
    jax_prepare_boundary.main(args[:1] + [str(tmp_path / "jax")] + args[1:])
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_prepare_hha_matches_its_encoder_and_jax(tmp_path):
    ds = JaxSynthetic(JaxDataConfig(train_img_shape=(64, 48)), "train")
    depth_dir = tmp_path / "depth"
    depth_dir.mkdir()
    mm = []
    for i in range(3):
        d = np.round(ds[i]["depth"] * 1000).astype(np.uint16)
        Image.fromarray(d).save(depth_dir / f"{i:03d}.png")
        mm.append(d)
    prepare_hha.main([str(depth_dir), str(tmp_path / "port"), "--batch", "2"])
    jax_prepare_hha.main([str(depth_dir), str(tmp_path / "jax"), "--batch", "2"])
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["000.png", "001.png", "002.png"]
    for i, name in enumerate(sorted(got)):
        own = depth_to_hha_batch(torch.from_numpy(mm[i].astype(np.float32) / 1000.0)[None])[0]
        np.testing.assert_array_equal(got[name], own.numpy().astype(np.uint8))
        diff = np.abs(got[name].astype(int) - want[name].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name


def test_organize_suncg_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    renders = tmp_path / "renders"
    for house in ("houseA", "houseB"):
        (renders / house).mkdir(parents=True)
        for frame in ("000001", "000002"):
            Image.fromarray(rng.randint(0, 255, (8, 12, 3), np.uint8)).save(
                renders / house / f"{frame}_mlt.png")
            Image.fromarray(rng.randint(0, 41, (8, 12), np.uint8)).save(
                renders / house / f"{frame}_category40.png")
            Image.fromarray((rng.rand(8, 12) * 4000).astype(np.uint16)).save(
                renders / house / f"{frame}_depth.png")
    Image.fromarray(rng.randint(0, 255, (8, 12, 3), np.uint8)).save(
        renders / "houseA" / "000003_mlt.png")  # unlabeled: skipped
    assert organize_suncg.organize(str(renders), str(tmp_path / "port"), copy=True) == 4
    assert jax_organize_suncg.organize(str(renders), str(tmp_path / "jax"), copy=True) == 4
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")


def test_prepare_nyu_matches_jax(tmp_path):
    import h5py
    import scipy.io

    n, h, w = 4, 12, 16
    rng = np.random.RandomState(0)
    with h5py.File(tmp_path / "labeled.mat", "w") as f:
        f["images"] = rng.randint(0, 255, (n, 3, w, h)).astype(np.uint8)
        f["depths"] = (rng.rand(n, w, h) * 5).astype(np.float32)
    scipy.io.savemat(tmp_path / "labels40.mat",
                     {"labels40": rng.randint(0, 41, (h, w, n)).astype(np.uint8)})
    scipy.io.savemat(tmp_path / "splits.mat", {"trainNdxs": np.array([[1], [2], [3]]),
                                               "testNdxs": np.array([[4]])})
    args = [str(tmp_path / "labeled.mat"), "--labels40", str(tmp_path / "labels40.mat"),
            "--splits", str(tmp_path / "splits.mat"), "--out"]
    prepare_nyu.main(args + [str(tmp_path / "port")])
    jax_prepare_nyu.main(args + [str(tmp_path / "jax")])
    _assert_trees_equal(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "train_rgb")) == 3
