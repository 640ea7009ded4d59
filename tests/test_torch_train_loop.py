"""The port's training loop: the sample stream, ``train_adapt`` end to end on
the CPU, checkpoints that the tester scores, resume, and the guards.

drn_d_14, input_ch 6 (HHA from raw depth), 40 classes, float32, batch 2 of
``synthetic`` -> ``synthetic_shifted`` decoded at 32x24 (the pre-crop
canvas 39x29 upscales it), num_k 2. Two samples per corpus make one
iteration an epoch, so every iteration ends on a checkpoint boundary.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.data.pipeline import _index_batches as jax_index_batches
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
from mcseg_tpu_torch.data.pipeline import _index_batches, batch_iterator
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.train.loops import check_finite, train_adapt
from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, load_params
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _cfg(out_dir, epochs=3, **train_kw):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_14", input_ch=6, n_class=40, dtype="float32"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=2, train_img_shape=(32, 24), test_img_shape=(32, 24),
                        input_ch=6, max_samples=2),
        train=TrainConfig(lr=0.01, num_k=2, epochs=epochs, max_steps=10, log_every=1,
                          out_dir=str(out_dir), **train_kw))


@pytest.mark.parametrize("start_epoch", [0, 2])
@pytest.mark.parametrize("shuffle", [True, False])
def test_index_stream_matches_jax(shuffle, start_epoch):
    args = (10, 3, shuffle, 7, True, 5)
    want = [list(b) for b in jax_index_batches(*args, start_epoch=start_epoch)]
    got = [list(b) for b in _index_batches(*args, start_epoch=start_epoch)]
    assert got == want and len(got) == 3 * (5 - start_epoch)


def test_zip_batches_pair_the_corpora():
    cfg = dataclasses.replace(_cfg("unused").data, max_samples=5)
    src = get_dataset("synthetic", cfg, "train")
    tgt = get_dataset("synthetic_shifted", dataclasses.replace(cfg, max_samples=3), "train")
    zipped = ZipDataset(src, tgt)
    assert len(zipped) == 3
    batches = list(batch_iterator(zipped, 2, seed=1, epochs=2))
    assert len(batches) == 2  # one full batch per epoch, the tail dropped
    idx = next(_index_batches(3, 2, True, 1, True, 2))
    s, t = batches[0]
    np.testing.assert_array_equal(s["image"], np.stack([src[int(i)]["image"] for i in idx]))
    np.testing.assert_array_equal(t["depth"], np.stack([tgt[int(i)]["depth"] for i in idx]))


def test_train_adapt_cpu_checkpoint_scored_by_evaluate(tmp_path):
    cfg = _cfg(tmp_path / "run")
    state = train_adapt(cfg, device="cpu")
    assert state.step == 3
    with open(tmp_path / "run" / "train_log.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert [r["step"] for r in lines] == [0, 1, 2]
    for r in lines:
        for k in ("loss_source", "loss_b", "loss_dis", "lr"):
            assert np.isfinite(r[k]), (k, r)
    assert lines[0]["lr"] == 0.01 and lines[2]["lr"] < lines[1]["lr"] < 0.01  # poly
    for name in ("ep1", "ep2", "ep3", "last"):
        assert os.path.exists(tmp_path / "run" / f"{name}.pt"), name
    # the sidecar is the JAX package's layout
    with open(tmp_path / "run" / "last.config.json") as f:
        JaxExperimentConfig.from_dict(json.load(f))
    params, ckpt_cfg = load_params(str(tmp_path / "run" / "last"))
    assert ckpt_cfg == cfg
    for name, m in (("G", state.g), ("F2", state.f2)):
        for k, v in m.state_dict().items():
            assert torch.equal(params[name][k], v), (name, k)
    miou, hist, _ = evaluate(params, ckpt_cfg, max_batches=1, print_table=False, device="cpu")
    assert np.isfinite(miou) and hist.sum() > 0


def test_resume_repeats_the_uninterrupted_run(tmp_path):
    """Stop after one iteration by SIGTERM (the graceful path writes
    ``last``), resume from it, and land bit-equal on an uninterrupted run."""
    full = train_adapt(_cfg(tmp_path / "full", epochs=2), device="cpu")

    def terminate(epoch, state):
        os.kill(os.getpid(), signal.SIGTERM)

    first = train_adapt(_cfg(tmp_path / "cut", epochs=2), on_epoch_end=terminate, device="cpu")
    assert first.step == 1
    prefix = str(tmp_path / "cut" / "last")
    restored, _ = load_checkpoint(prefix, device="cpu")
    assert restored.step == 1 and restored.opt_g.state  # momentum came back
    resumed = train_adapt(_cfg(tmp_path / "cut", epochs=2, resume=prefix), device="cpu")
    assert resumed.step == 2
    for a, b in ((full.g, resumed.g), (full.f1, resumed.f1), (full.f2, resumed.f2)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), k


def test_guards():
    with pytest.raises(FloatingPointError, match="loss_b"):
        check_finite({"loss_source": torch.tensor(1.0), "loss_b": torch.tensor(float("nan"))}, 3)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_adapt(_cfg("/nonexistent/never_written"))
