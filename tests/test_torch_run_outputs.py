"""The run outputs of the port against the JAX package's: the tester's
prediction dumps (``evaluate(save_dir=..., saves_prob=...)``, the test
commands' ``--outdir`` / ``--saves_prob``) and the trainers' TensorBoard
scalars (``--tb_dir``, ``utils/logging.JsonlLogger``).

Dumps: drn_d_14, 40 classes, 32x32, float32 on both sides, JAX's weights
carried by ``params_from_jax``, batch 2 over 3 ``synthetic_shifted`` val
samples (the tail batch is padded, and padding is never dumped). The label
and colour PNGs decode pixel-equal to JAX's; the float16 probability maps
within 1e-3 (two float16 roundings of float32 softmaxes that agree to
~1e-6, an ulp of float16 below 1 being 2^-11). TensorBoard: the same
records through both loggers give the same tags, steps and values, read
back with tensorboard's ``EventAccumulator`` (JAX writes TF2 tensor
summaries, the port ``SummaryWriter`` scalars).
"""

import glob
import os
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
from tensorboard.util import tensor_util

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.data import transforms as jax_transforms
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu.utils.logging import JsonlLogger as JaxJsonlLogger
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.data import transforms
from mcseg_tpu_torch.data.datasets import get_dataset
from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from mcseg_tpu_torch.utils.logging import JsonlLogger
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

PROB_ATOL = 1e-3


def test_colorize_and_color_png_match_jax(tmp_path):
    palette = get_label_spec("nyu")[3]
    rng = np.random.RandomState(0)
    label = rng.randint(0, 60, (9, 11)).astype(np.uint8)  # ids past the palette clip
    label[0, :4] = 255  # ignore -> black
    want = jax_transforms.colorize(label, palette)
    got = transforms.colorize(label, palette)
    assert got.dtype == np.uint8 and got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[0, :4].any()
    transforms.save_color_png(label, palette, str(tmp_path / "ours.png"))
    jax_transforms.save_color_png(label, palette, str(tmp_path / "theirs.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ours.png")),
                                  np.asarray(Image.open(tmp_path / "theirs.png")))


def test_evaluate_dumps_match_jax(tmp_path):
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=3, n_class=40, dtype="float32"),
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                           batch_size=2, train_img_shape=(32, 32), test_img_shape=(32, 32),
                           input_ch=3, max_samples=3),
        train=JaxTrainConfig())
    state, _, _ = jax_create_train_state(cfg.model, cfg.train, jax.random.key(0),
                                         img_shape=(32, 32))
    jax_evaluate((state.params, state.batch_stats), cfg,
                 dataset=jax_get_dataset("synthetic_shifted", cfg.data, "val"),
                 print_table=False, num_workers=0, save_dir=str(tmp_path / "jax"),
                 saves_prob=True)
    pcfg = ExperimentConfig.from_dict(cfg.to_dict())
    params = params_from_jax(*jax.tree.map(np.asarray, (state.params, state.batch_stats)))
    evaluate(params, pcfg, dataset=get_dataset("synthetic_shifted", pcfg.data, "val"),
             print_table=False, device="cpu", save_dir=str(tmp_path / "port"), saves_prob=True)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"{i:06d}_{kind}" for i in range(3)
                     for kind in ("color.png", "label.png", "prob.npy")]
    for name in names:
        ours, theirs = tmp_path / "port" / name, tmp_path / "jax" / name
        if name.endswith(".npy"):
            got, want = np.load(ours), np.load(theirs)
            assert got.dtype == want.dtype == np.float16 and got.shape == (32, 32, 40)
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32),
                                       rtol=0, atol=PROB_ATOL)
        else:
            got, want = np.asarray(Image.open(ours)), np.asarray(Image.open(theirs))
            assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_dumps_without_saves_prob_have_no_probabilities(tmp_path):
    cfg = ExperimentConfig.from_dict(JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=3, n_class=40, dtype="float32"),
        data=JaxDataConfig(tgt_dataset="synthetic_shifted", batch_size=2,
                           test_img_shape=(32, 24), input_ch=3, max_samples=1)).to_dict())
    from mcseg_tpu_torch.models.factory import init_models

    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    evaluate(params, cfg, print_table=False, device="cpu", save_dir=str(tmp_path / "d"),
             saves_prob=False)
    assert sorted(os.listdir(tmp_path / "d")) == ["000000_color.png", "000000_label.png"]
    label = np.asarray(Image.open(tmp_path / "d" / "000000_label.png"))
    assert label.shape == (24, 32) and label.max() < 40


RECORDS = [
    {"step": 0, "loss_source": np.float32(2.5), "loss_b": np.float32(0.125),
     "img_per_sec": 0.0, "epoch": 1},
    {"step": 1, "loss_source": np.float32(2.25), "loss_b": np.float32(0.0625),
     "img_per_sec": 33.5},
    {"step": 2, "epoch": 1, "val_miou": 12.345},
]


def _port_record(r):
    return {k: (torch.tensor(v) if isinstance(v, np.floating) else v) for k, v in r.items()}


def _scalars(tb_dir):
    """{tag: [(step, value)]} of every event file under ``tb_dir``, scalar
    summaries and TF2 tensor summaries alike."""
    (path,) = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
    acc = EventAccumulator(path)
    acc.Reload()
    out = {t: [(e.step, float(np.float32(e.value))) for e in acc.Scalars(t)]
           for t in acc.Tags()["scalars"]}
    for t in acc.Tags()["tensors"]:
        out[t] = [(e.step, float(tensor_util.make_ndarray(e.tensor_proto)))
                  for e in acc.Tensors(t)]
    return out


def test_tb_scalars_match_jax(tmp_path):
    theirs = JaxJsonlLogger(path=None, echo=False, tb_dir=str(tmp_path / "jax"))
    ours = JsonlLogger(path=None, echo=False, tb_dir=str(tmp_path / "port"))
    for r in RECORDS:
        theirs.log(dict(r))
        ours.log(_port_record(r))
    theirs.close()
    ours.close()
    want, got = _scalars(str(tmp_path / "jax")), _scalars(str(tmp_path / "port"))
    assert got == want
    assert sorted(got) == ["img_per_sec", "loss_b", "loss_source", "val_miou"]
    assert got["loss_source"] == [(0, 2.5), (1, 2.25)]
    assert got["val_miou"] == [(2, float(np.float32(12.345)))]


def test_tb_dir_without_tensorboard_warns_and_logs_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    logger = JsonlLogger(path=str(tmp_path / "log.jsonl"), echo=False,
                         tb_dir=str(tmp_path / "tb"))
    logger.log(_port_record(RECORDS[0]))
    logger.close()
    assert f"warning: --tb_dir {str(tmp_path / 'tb')!r} ignored (no tensorboard)" in \
        capsys.readouterr().out
    assert not os.path.exists(tmp_path / "tb")
    with open(tmp_path / "log.jsonl") as f:
        assert '"loss_source": 2.5' in f.read()


@pytest.mark.parametrize("kind", ["colour", "label"])
def test_dump_pngs_are_read_back_by_pil(tmp_path, kind):
    """The standard-library PNG writer's dumps decode with PIL to the
    arrays written (uint8 gray for labels, RGB for colours)."""
    palette = get_label_spec("city")[3]
    label = np.random.RandomState(5).randint(0, 19, (7, 13)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    if kind == "label":
        transforms.save_label_png(label, path)
        want = label
    else:
        transforms.save_color_png(label, palette, path)
        want = transforms.colorize(label, palette)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
