"""The host side of a training run on the CPU: the card-resident corpus,
the input stream, asynchronous checkpoints, ``--input_ch 7`` and the
Cityscapes submission dumps.

* ``train_adapt`` for 2 iterations (drn_d_14, float32, synthetic ->
  synthetic_shifted at 32x24, batch 2) with ``--device_corpus on`` and
  ``off`` (two decode threads) ends with bit-identical parameters and
  momentum, as ``tests/test_device_corpus.py`` asserts for JAX.
* An epoch checkpoint written in the background equals the one written
  synchronously bit for bit; ``save`` copies the state, so a step taken
  right after it does not reach the file; a failed write raises on the
  next ``save``.
* ``--input_ch 7`` (RGB + HHA + the binarized boundary plane): the stack
  function in float64 within 1e-12 of JAX's ``_normalize_stack``; the
  train and eval preprocess in float32 within the bounds of
  ``tests/test_torch_train_preprocess.py`` (RGB and boundary 1e-5, HHA
  2e-3), labels bit-equal; one float64 MCD iteration of drn_d_14 from
  JAX's weights (``params_from_jax`` places the 7-channel first conv)
  within 1e-9 of JAX's ``make_mcd_step``, the bound of
  ``tests/test_torch_mcd.py``.
* ``--submit_dir`` on a Cityscapes val layout: the port's dumps equal
  JAX's pixel for pixel after decoding (float64 on both sides, so no
  argmax tie can differ), with the same names.
"""

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import jax_params, jax_train_draws, x64
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.ops.preprocess import _normalize_stack as jax_normalize_stack
from mcseg_tpu.ops.preprocess import make_eval_preprocess as jax_make_eval_preprocess
from mcseg_tpu.ops.preprocess import make_train_preprocess as jax_make_train_preprocess
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import (
    DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
from mcseg_tpu_torch.data.datasets import SyntheticDataset, get_dataset, stack_samples
from mcseg_tpu_torch.data.device_corpus import stage_corpus
from mcseg_tpu_torch.data.pipeline import batch_iterator, device_prefetch
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.ops.normalize import normalize_stack_reference
from mcseg_tpu_torch.ops.preprocess import (
    make_eval_preprocess, make_train_preprocess, pre_crop_canvas)
from mcseg_tpu_torch.train.loops import train_adapt
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import AsyncCheckpointer, save_checkpoint
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from tests.test_corpus_layouts import make_cityscapes
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _cfg(out_dir, epochs=1, **data_kw):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_14", input_ch=6, n_class=40, dtype="float32"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=2, train_img_shape=(32, 24), test_img_shape=(32, 24),
                        input_ch=6, max_samples=4, **data_kw),
        train=TrainConfig(lr=0.01, num_k=2, epochs=epochs, max_steps=10, log_every=1,
                          out_dir=str(out_dir)))


def _assert_state_equal(a, b):
    for (name, x), (_, y) in zip(a.modules().items(), b.modules().items()):
        for (k, v), (_, w) in zip(x.state_dict().items(), y.state_dict().items()):
            assert torch.equal(v, w), (name, k)
    for opt in ("opt_g", "opt_f"):
        sa, sb = getattr(a, opt).state_dict()["state"], getattr(b, opt).state_dict()["state"]
        assert sa.keys() == sb.keys() and sa
        for k in sa:
            assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"]), (opt, k)


def test_device_corpus_on_and_off_train_bit_identically(tmp_path):
    on = train_adapt(_cfg(tmp_path / "on", device_corpus="on"), device="cpu")
    off = train_adapt(_cfg(tmp_path / "off", device_corpus="off", num_workers=2),
                      device="cpu")
    assert on.step == off.step == 2
    _assert_state_equal(on, off)


def test_stage_corpus_rejects_inconsistent_planes():
    class Inconsistent:
        def __len__(self):
            return 4

        def get_batch(self, idx):
            b = {"image": np.zeros((len(idx), 8, 8, 3), np.uint8)}
            if idx[0] < 2:  # the first chunk has depth, the next does not
                b["depth"] = np.zeros((len(idx), 8, 8), np.float32)
            return b

    with pytest.raises(ValueError, match="inconsistent planes"):
        stage_corpus(Inconsistent(), "cpu", chunk=2)


def test_prefetch_thread_ends_with_an_abandoned_stream():
    ds = SyntheticDataset(DataConfig(train_img_shape=(16, 16), max_samples=8))
    before = set(threading.enumerate())
    it = device_prefetch(batch_iterator(ds, 2, epochs=None, num_workers=2), "cpu", depth=1)
    next(it)
    it.close()
    deadline = time.time() + 10.0
    while time.time() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, leaked


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_payload_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_payload_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_payload_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_async_epoch_checkpoint_equals_sync(tmp_path):
    train_adapt(_cfg(tmp_path / "async", epochs=2), device="cpu")
    sync_cfg = _cfg(tmp_path / "sync", epochs=2)
    sync_cfg = dataclasses.replace(sync_cfg, train=dataclasses.replace(
        sync_cfg.train, async_checkpoint=False))
    train_adapt(sync_cfg, device="cpu")
    for name in ("ep1", "ep2", "last"):
        _assert_payload_equal(_load(tmp_path / "async" / f"{name}.pt"),
                              _load(tmp_path / "sync" / f"{name}.pt"), name)


def test_async_save_copies_the_state_and_raises_a_failed_write(tmp_path):
    cfg = _cfg(tmp_path)
    state = create_train_state(cfg.model, cfg.train, 0, "cpu")
    save_checkpoint(str(tmp_path / "want"), state, cfg)
    ckpt = AsyncCheckpointer()
    try:
        ckpt.save(str(tmp_path / "got"), state, cfg)
        with torch.no_grad():  # a step right after save, in place
            for p in state.g.parameters():
                p.add_(1.0)
        ckpt.join()
        _assert_payload_equal(_load(tmp_path / "got.pt"), _load(tmp_path / "want.pt"))
        blocker = tmp_path / "a_file"
        blocker.write_text("")
        ckpt.save(str(blocker / "ep1"), state, cfg)  # its directory cannot be made
        ckpt._q.join()
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            ckpt.save(str(tmp_path / "ep2"), state, cfg)
    finally:
        ckpt.close()


# --- input_ch 7 -------------------------------------------------------------

def _boundary_batch(decode_wh, n, seed=0):
    raw = stack_samples(get_dataset("synthetic", DataConfig(train_img_shape=decode_wh,
                                                            max_samples=n), "train"), range(n))
    rng = np.random.RandomState(seed)
    raw["boundary"] = (rng.rand(n, decode_wh[1], decode_wh[0]) < 0.1).astype(np.uint8) * 255
    return raw


def test_input_ch7_stack_matches_jax_fp64():
    rng = np.random.RandomState(30)
    rgb01, extra = rng.rand(2, 6, 5, 3), rng.rand(2, 6, 5, 4)
    with x64():
        want = np.asarray(jax_normalize_stack(jnp.asarray(rgb01), jnp.asarray(extra), 7))
    got = normalize_stack_reference(torch.from_numpy(rgb01), torch.from_numpy(extra),
                                    torch.zeros(2, dtype=torch.int32), 7, torch.float64)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape == (2, 6, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("geometry", ["upscale", "resize_then_crop"])
def test_input_ch7_train_preprocess_matches_jax(geometry):
    decode = (64, 48) if geometry == "upscale" else (96, 72)
    raw = _boundary_batch(decode, 3)
    jcfg = JaxDataConfig(src_dataset="synthetic", train_img_shape=(64, 48), input_ch=7,
                         hha_on_device=True)
    pcfg = DataConfig.from_dict(jcfg.to_dict())
    key = jax.random.key(12)
    want_img, want_lbl = jax.jit(jax_make_train_preprocess(jcfg))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    pre, target = pre_crop_canvas(pcfg)
    draws = jax_train_draws(key, 3, pre, target, True, True)
    got_img, got_lbl = make_train_preprocess(pcfg)(
        {k: torch.as_tensor(v) for k, v in raw.items()}, *draws)
    want_img = np.asarray(want_img)
    assert tuple(got_img.shape) == want_img.shape == (3, 48, 64, 7)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    got_img = got_img.numpy()
    np.testing.assert_allclose(got_img[..., :3], want_img[..., :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_img[..., 3:6], want_img[..., 3:6], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got_img[..., 6], want_img[..., 6], rtol=0, atol=1e-5)
    assert 0 < int(draws[2].sum()) < 3  # mixed flips


def test_input_ch7_eval_preprocess_matches_jax():
    raw = _boundary_batch((64, 48), 2, seed=1)
    kw = dict(tgt_dataset="synthetic", test_img_shape=(64, 48), input_ch=7)
    want_img, want_lbl = jax_make_eval_preprocess(JaxDataConfig(**kw))(
        {k: jnp.asarray(v) for k, v in raw.items()})
    got_img, got_lbl = make_eval_preprocess(DataConfig(**kw))(
        {k: torch.as_tensor(v) for k, v in raw.items()})
    want_img = np.asarray(want_img)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    np.testing.assert_allclose(got_img.numpy()[..., [0, 1, 2, 6]], want_img[..., [0, 1, 2, 6]],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_img.numpy()[..., 3:6], want_img[..., 3:6], rtol=0, atol=2e-3)


def test_input_ch7_mcd_iteration_matches_jax_fp64():
    b, h, w, nc = 2, 24, 16, 5
    tcfg = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2,
                d_loss="diff", lr_schedule="poly", lr_power=0.9, max_steps=8)
    mcfg = JaxModelConfig(net="drn_d_14", input_ch=7, n_class=nc, dtype="float64",
                          upsample="convt")
    params, stats = jax_params(mcfg, img_hw=(h, w), seed=7)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    stats = jax.tree.map(lambda a: np.asarray(a, np.float64), stats)
    rng = np.random.RandomState(8)
    xs, xt = rng.randn(b, h, w, 7), rng.randn(b, h, w, 7)
    ys = rng.randint(0, nc, (b, h, w))
    with x64():
        jt = JaxTrainConfig(**tcfg)
        tx_g = jax_get_optimizer("sgd", jt.lr, jt.momentum, jt.weight_decay)
        tx_f = jax_get_optimizer("sgd", jt.lr, jt.momentum, jt.weight_decay)
        p = jax.tree.map(jnp.asarray, params)
        jstate = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=jax.random.key(1))
        step = jax.jit(jax_make_mcd_step(*jax_get_models(mcfg), tx_g, tx_f, jt))
        jstate, jmetrics = step(jstate, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
        want_p = jax.tree.map(lambda a: np.asarray(a, np.float64), jstate.params)
        want_s = jax.tree.map(lambda a: np.asarray(a, np.float64), jstate.batch_stats["G"])
    port = params_from_jax(params, stats)
    assert tuple(port["G"]["conv0.weight"].shape)[:2] == (16, 7)
    state = create_train_state(ModelConfig(net="drn_d_14", input_ch=7, n_class=nc,
                                           dtype="float64", upsample="convt"),
                               TrainConfig(**tcfg), device="cpu", params=port)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    metrics = make_mcd_step(TrainConfig(**tcfg), False, torch.float64)(
        state, nchw(xs), torch.from_numpy(ys), nchw(xt))
    for k in ("loss_source", "loss_b", "loss_dis", "lr"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-9, atol=0)
    got_p, got_s = params_to_jax(state.params())

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    assert max(jax.tree.leaves(jax.tree.map(rel, got_p, want_p))) < 1e-9
    assert max(jax.tree.leaves(jax.tree.map(rel, got_s["G"], want_s))) < 1e-9


# --- --submit_dir -------------------------------------------------------------

def test_submit_dumps_match_jax(tmp_path):
    make_cityscapes(tmp_path / "city", n=2, splits=("val",))
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=3, n_class=19, dtype="float64"),
        data=JaxDataConfig(src_dataset="city", tgt_dataset="city", batch_size=1,
                           test_img_shape=(64, 32), input_ch=3, data_root=str(tmp_path)))
    params, stats = jax_params(cfg.model, img_hw=(32, 64), seed=9)
    pcfg = ExperimentConfig.from_dict(cfg.to_dict())
    with x64():
        jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        jstats = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats)
        jax_evaluate((jparams, jstats), cfg, dataset=jax_get_dataset("city", cfg.data, "val"),
                     print_table=False, num_workers=0, submit_dir=str(tmp_path / "jax"))
    evaluate(params_from_jax(params, stats), pcfg, print_table=False, device="cpu",
             num_workers=2, submit_dir=str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        f"cityA_{i:06d}_000019_leftImg8bit.png" for i in range(2)]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert got.shape == (1024, 2048) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert set(np.unique(got)) <= {7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25,
                                       26, 27, 28, 31, 32, 33}  # labelIds, not train ids
    with pytest.raises(ValueError, match="no submission protocol"):
        evaluate(params_from_jax(params, stats),
                 dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, tgt_dataset="nyu")),
                 device="cpu", submit_dir=str(tmp_path / "nyu"))
    assert not os.path.exists(tmp_path / "nyu")


# --- the commands on files ------------------------------------------------------

def test_file_fed_commands_suncg_to_nyu_input_ch7(tmp_path, capsys):
    """``adapt_train suncg nyu --input_ch 7`` on written layouts (16-bit depth
    and boundary PNGs, one --data_root), on the host stream with two decode
    threads and the disk cache, then ``adapt_test`` of its checkpoint."""
    from mcseg_tpu_torch.cli import adapt_test, adapt_train
    from tests.test_corpus_layouts import make_nyu_like

    make_nyu_like(tmp_path / "suncg", n=2, splits=("train",), with_boundary=True)
    make_nyu_like(tmp_path / "nyu", n=2, with_boundary=True)
    out = tmp_path / "run"
    state = adapt_train.main(
        ["suncg", "nyu", "--net", "drn_d_14", "--dtype", "float32", "--input_ch", "7",
         "--data_root", str(tmp_path), "--batch_size", "2", "--train_img_shape", "64", "32",
         "--epochs", "2", "--num_k", "1", "--log_every", "1", "--num_workers", "2",
         "--device_corpus", "off", "--decode_disk_cache_gb", "1", "--out_dir", str(out)],
        device="cpu")
    assert state.step == 2 and tuple(state.g.conv0.weight.shape)[1] == 7
    for name in ("ep1", "ep2", "last"):
        assert os.path.exists(out / f"{name}.pt"), name
    assert sorted(os.listdir(tmp_path / "suncg" / ".mcseg_decode_cache")) == ["suncg_train_640x480"]
    capsys.readouterr()
    miou = adapt_test.main([str(out / "last"), "--data_root", str(tmp_path),
                            "--batch_size", "2"], device="cpu")
    assert np.isfinite(miou) and "mIoU" in capsys.readouterr().out
