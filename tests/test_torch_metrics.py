"""Port of the metrics (mcseg_tpu_torch/eval/metrics.py), configs and
synthetic readers against the JAX package: all exact."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.data import datasets as jax_datasets
from mcseg_tpu.data import labels as jax_labels
from mcseg_tpu.eval import metrics as jax_metrics
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig
from mcseg_tpu_torch.data import datasets, labels
from mcseg_tpu_torch.eval import metrics
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_v1.config.json")


def test_fast_hist_and_iou_match_jax():
    rng = np.random.RandomState(0)
    n = 7
    gt = rng.randint(0, n, (2, 9, 11)).astype(np.int32)
    gt[0, :2] = 255  # ignored
    gt[1, 0, :3] = n + 2  # out of range: dropped too
    pred = rng.randint(0, n, (2, 9, 11)).astype(np.int32)
    got = metrics.fast_hist(torch.from_numpy(gt), torch.from_numpy(pred), n)
    want = np.asarray(jax_metrics.fast_hist(jnp.asarray(gt), jnp.asarray(pred), n))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    h = got.numpy()
    np.testing.assert_array_equal(metrics.per_class_iu(h), jax_metrics.per_class_iu(h))
    assert metrics.miou_from_hist(h) == jax_metrics.miou_from_hist(h)
    assert metrics.pixel_accuracy(h) == jax_metrics.pixel_accuracy(h)
    names = [f"c{i}" for i in range(n)]
    assert metrics.format_iou_table(h, names) == jax_metrics.format_iou_table(h, names)


def test_config_reads_jax_sidecar_unchanged():
    with open(FIXTURE) as f:
        d = json.load(f)
    ours = ExperimentConfig.from_dict(d)
    theirs = JaxExperimentConfig.from_dict(d)
    assert ours.to_dict() == theirs.to_dict()
    assert ExperimentConfig.from_dict(ours.to_dict()) == ours
    assert ExperimentConfig().to_dict() == JaxExperimentConfig().to_dict()


def test_label_spec_matches_jax():
    for name in ("nyu", "nyudv2", "suncg", "synthetic", "synthetic_shifted",
                 "city", "cityscapes", "gta", "gta5", "ir", "synthia"):
        n, table, names, palette = labels.get_label_spec(name)
        jn, jtable, jnames, jpalette = jax_labels.get_label_spec(name)
        assert (n, tuple(names)) == (jn, tuple(jnames))
        np.testing.assert_array_equal(table, jtable)
        np.testing.assert_array_equal(palette, jpalette)
    with pytest.raises(ValueError):
        labels.get_label_spec("kitti")  # no label space of the reference


@pytest.mark.parametrize("name", ["synthetic", "synthetic_shifted"])
def test_synthetic_readers_match_jax_sample_for_sample(name):
    kw = dict(test_img_shape=(40, 30), train_img_shape=(48, 32), domain_shift=0.7)
    for split in ("train", "val"):
        ours = datasets.get_dataset(name, DataConfig(**kw), split)
        theirs = jax_datasets.get_dataset(name, JaxDataConfig(**kw), split)
        assert len(ours) == len(theirs) and ours.decode_size == theirs.decode_size
        for i in (0, 5):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
