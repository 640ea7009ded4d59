"""The learning evidence's harness on the CPU: the adaptation A/B that
``chip_smoke.py`` phase ``learning`` runs on the card (the JAX package's
``tests/test_adaptation_gain.py:53-66``: drn_d_22, RGB, 40 classes,
``synthetic`` -> ``synthetic_shifted`` at 64x48, batch 8, 32 samples, no
random crop, SGD lr 0.05 constant, ``num_k`` 4), held to the JAX package,
and the port's counterpart of JAX's slow ``tests/test_learning.py:27``.

1. The harness's corpora (``synthetic`` train, ``synthetic_shifted`` train
   and val, domain shift 1.0) are byte-equal to the JAX package's.
2. The three arms (source-only, the one-classifier ablation, MCD) run 8
   iterations in float64 through the port's ``train_source`` /
   ``train_adapt`` and the JAX package's loops (one device), from one state
   the port wrote as a JAX ``.msgpack``; JAX's loops train on the batches
   the port preprocessed (``jax_loops_fed``), and both log every
   iteration. The harness's data is cut to batch 2 of 8 samples at 32x24
   (``PARITY``; still 4 iterations an epoch): at batch 8 of 64x48 the
   float64 convolutions of both sides kept the file over 20 minutes on an
   8-core CPU. Bound: every logged loss and lr within rtol 1e-6 (the
   horizon bound of ``tests/test_trajectory_parity.py``), the
   one-classifier ``loss_dis`` under 1e-12 on both sides, and the final
   states' target-val mIoU (4 batches, 8 images; F1 alone for source-only, F1 and F2
   averaged otherwise) within 1e-6.
3. ``train_source`` at ``tests/test_learning.py:27``'s config for 45
   float32 iterations learns: mIoU above 0.10 and pixel accuracy above 0.45
   on two batches of the train distribution, the last logged loss under 3.0
   (that test's gates; chance is ~0.02 mIoU, ~0.2 pixel accuracy).
"""

import dataclasses
import shutil

import numpy as np
import pytest

from _torch_parallel_worker import logged
from _torch_parity import jax_loops_fed, recording_train_inputs, x64
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu.parallel.mesh import make_mesh
from mcseg_tpu.train.loops import train_adapt as jax_train_adapt
from mcseg_tpu.train.loops import train_source as jax_train_source
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.data.datasets import SyntheticDataset, get_dataset
from mcseg_tpu_torch.eval.metrics import pixel_accuracy
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.train import loops
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import save_jax_checkpoint
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

ITERATIONS = 8
PARITY = dict(batch=2, hw=(32, 24), samples=8)  # the harness's data, cut for float64
REL = 1e-6
ZERO_DIS = 1e-12
VAL_BATCHES = 4  # as the harness scores (there 32 val images, here PARITY's 8)
ARMS = ("source", "one_classifier", "mcd")
LOSSES = {"source": ("loss", "lr"), "one_classifier": ("loss_source", "loss_b", "loss_dis", "lr"),
          "mcd": ("loss_source", "loss_b", "loss_dis", "lr")}


def _harness(out_dir, arm="mcd", dtype="float64", resume="", log_every=1, batch=8,
             hw=(64, 48), samples=32):
    """The A/B harness (``chip_smoke._ab_config``) in ``dtype``, a record
    logged every ``log_every`` iterations, batch ``batch`` of ``samples``
    samples at ``hw`` (W, H)."""
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=3, n_class=40, dtype=dtype,
                          uses_one_classifier=arm == "one_classifier"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=batch, train_img_shape=hw, test_img_shape=hw,
                        input_ch=3, max_samples=samples, random_crop=False,
                        domain_shift=1.0, num_workers=0),
        train=TrainConfig(lr=0.05, lr_schedule="constant", epochs=500, num_k=4,
                          max_steps=10_000, log_every=log_every, out_dir=str(out_dir),
                          checkpoint_every_epochs=0, resume=resume))


def _jax_config(cfg, out_dir):
    return JaxExperimentConfig.from_dict(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, out_dir=str(out_dir))).to_dict())


@pytest.mark.parametrize("name,split", [("synthetic", "train"), ("synthetic_shifted", "train"),
                                        ("synthetic_shifted", "val")])
def test_harness_corpus_equals_jax(name, split, tmp_path):
    cfg = _harness(tmp_path)
    ours = get_dataset(name, cfg.data, split)
    theirs = jax_get_dataset(name, _jax_config(cfg, tmp_path).data, split)
    assert len(ours) == len(theirs) == 32
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b), (i, sorted(a), sorted(b))
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            assert a[k].tobytes() == b[k].tobytes(), (name, split, i, k)


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """Each arm on both sides, from one state; per arm the logged records
    of both and the final states' target-val mIoU. The run directories go
    after each arm (each holds two float64 states), the first state at the
    end."""
    tmp = tmp_path_factory.mktemp("learning")
    init = str(tmp / "init")
    cfg0 = _harness(tmp / "unused", **PARITY)
    save_jax_checkpoint(init, create_train_state(cfg0.model, cfg0.train, 0, "cpu"), cfg0)
    out = {}
    for arm in ARMS:
        cfg = _harness(tmp / arm / "port", arm, resume=init, **PARITY)
        adapt = arm != "source"
        with recording_train_inputs(loops) as recorded:
            state = (loops.train_adapt if adapt else loops.train_source)(
                cfg, max_iterations=ITERATIONS, device="cpu")
        assert state.step == ITERATIONS and len(recorded) == (1 + adapt) * ITERATIONS
        val = get_dataset("synthetic_shifted", cfg.data, "val")
        miou, _, _ = evaluate(state.params(), cfg, val, max_batches=VAL_BATCHES,
                              print_table=False, device="cpu", average_classifiers=adapt,
                              num_workers=0)
        jcfg = _jax_config(cfg, tmp / arm / "jax")
        with x64():
            with jax_loops_fed(recorded, pairs=adapt):
                jstate = (jax_train_adapt if adapt else jax_train_source)(
                    jcfg, mesh=make_mesh(1), max_iterations=ITERATIONS)
            jmiou, _, _ = jax_evaluate(
                jstate, jcfg, jax_get_dataset("synthetic_shifted", jcfg.data, "val"),
                average_classifiers=adapt, max_batches=VAL_BATCHES, print_table=False,
                mesh=make_mesh(1), num_workers=0)
        out[arm] = {"port": logged(tmp / arm / "port", LOSSES[arm]),
                    "jax": logged(tmp / arm / "jax", LOSSES[arm]),
                    "miou": (float(miou), float(jmiou))}
        shutil.rmtree(tmp / arm)
    shutil.rmtree(tmp)
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_arm_losses_equal_jax(arms, arm):
    got, want = arms[arm]["port"], arms[arm]["jax"]
    assert got.shape == want.shape == (ITERATIONS, len(LOSSES[arm]))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)


def test_one_classifier_discrepancy_is_zero(arms):
    col = LOSSES["one_classifier"].index("loss_dis")
    for side in ("port", "jax"):
        assert np.max(np.abs(arms["one_classifier"][side][:, col])) < ZERO_DIS, side
    # MCD's is not: the two classifiers disagree from the first iteration
    assert np.min(arms["mcd"]["port"][:, LOSSES["mcd"].index("loss_dis")]) > 1e-6


@pytest.mark.parametrize("arm", ARMS)
def test_arm_target_miou_equals_jax(arms, arm):
    ours, theirs = arms[arm]["miou"]
    assert 0.0 < ours < 1.0
    assert abs(ours - theirs) < REL, (ours, theirs)


def test_source_training_reaches_reasonable_miou(tmp_path):
    """``tests/test_learning.py:27`` through the port: drn_d_22 RGB, 40
    classes, float32, batch 8 of 24 ``synthetic`` samples at 64x48, no
    random crop, lr 0.05 constant, 45 iterations, scored with F1 on two
    batches of the train split; no epoch checkpoints."""
    cfg = ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=3, n_class=40, dtype="float32"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic", batch_size=8,
                        train_img_shape=(64, 48), test_img_shape=(64, 48), input_ch=3,
                        max_samples=24, random_crop=False, num_workers=0),
        train=TrainConfig(lr=0.05, lr_schedule="constant", epochs=15, max_steps=1000,
                          log_every=5, out_dir=str(tmp_path / "run"),
                          checkpoint_every_epochs=0))  # 15 epoch states would fill a disk
    state = loops.train_source(cfg, max_iterations=45, device="cpu")
    miou, hist, _ = evaluate(state.params(), cfg, SyntheticDataset(cfg.data, "train"),
                             average_classifiers=False, max_batches=2, print_table=False,
                             device="cpu", num_workers=0)
    last = logged(tmp_path / "run", ("step", "loss"))[-1]
    assert state.step == 45 and last[0] == 40
    assert miou > 0.10, (miou, last)
    assert pixel_accuracy(hist) > 0.45, pixel_accuracy(hist)
    assert last[1] < 3.0, last
