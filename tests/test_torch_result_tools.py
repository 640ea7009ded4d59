"""The port's result tools against the JAX package's on the same files:
``cli/evaluate_preds.py``, ``tools/make_result_sheet.py``,
``tools/summarize_run.py`` and ``tools/parity_eval.py``.

A tiny NYU-layout val corpus (3 samples written at the reader's 640x480,
raw NYU ids) and a reference ``.pth.tar`` (the torch DRN-D-22 of
``tests/test_golden_drn.py`` with two 1x1 heads, 40 classes) serve every
test. ``parity_eval --dtype float32`` at 32x24 in batches of 2 (the
ignore-padded tail batch scored too) gives JAX's mIoU within 1e-6, the
testers' bound (``tests/test_torch_cli_tester.py``); its ``--outdir``
label dumps are then scored by both ``evaluate_preds`` (with and without
``--gt_raw``), whose mIoU equals the tester's exactly (one histogram of
the same pixels), and tiled by both ``make_result_sheet``, pixel for
pixel. ``summarize_run`` reads a port run directory as JAX's does, the
checkpoint lines aside."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from mcseg_tpu.cli import evaluate_preds as jax_evaluate_preds
from mcseg_tpu.tools import make_result_sheet as jax_make_result_sheet
from mcseg_tpu.tools import parity_eval as jax_parity_eval
from mcseg_tpu.tools import summarize_run as jax_summarize_run
from mcseg_tpu_torch.cli import adapt_train, evaluate_preds
from mcseg_tpu_torch.data.labels import nyu40_raw_to_train_table
from mcseg_tpu_torch.tools import make_result_sheet, parity_eval, summarize_run
from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, save_jax_checkpoint
from tests.test_golden_drn import TorchDRND22
from tests.test_import_cli import _TorchHead
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

N, H, W = 3, 480, 640


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("result_tools")
    rng = np.random.RandomState(0)
    for i in range(N):
        stem = f"{i:06d}.png"  # the tester dumps {idx:06d}_label.png
        for sub, arr in (("val_rgb", rng.randint(0, 255, (H, W, 3)).astype(np.uint8)),
                         ("val_label", rng.randint(0, 41, (H // 16, W // 16)).astype(np.uint8)
                          .repeat(16, 0).repeat(16, 1))):
            os.makedirs(root / "nyu" / sub, exist_ok=True)
            Image.fromarray(arr).save(root / "nyu" / sub / stem)
    # the same GT in train ids, for evaluate_preds without --gt_raw
    table = nyu40_raw_to_train_table()
    os.makedirs(root / "gt_train")
    for i in range(N):
        raw = np.asarray(Image.open(root / "nyu" / "val_label" / f"{i:06d}.png"))
        Image.fromarray(table[raw].astype(np.uint8)).save(root / "gt_train" / f"{i:06d}.png")
    torch.manual_seed(0)
    ckpt = str(root / "ref.pth.tar")
    torch.save({"epoch": 3, "g_state_dict": TorchDRND22().state_dict(),
                "f1_state_dict": _TorchHead(40).state_dict(),
                "f2_state_dict": _TorchHead(40).state_dict()}, ckpt)
    return root, ckpt


def _parity_argv(root, ckpt, outdir):
    return [ckpt, "--dataset", "nyu", "--data_root", str(root), "--net", "drn_d_22",
            "--dtype", "float32", "--test_img_shape", "32", "24", "--batch_size", "2",
            "--outdir", str(outdir)]


@pytest.fixture(scope="module")
def parity(files):
    root, ckpt = files
    want = jax_parity_eval.main(_parity_argv(root, ckpt, root / "jax_dumps"))
    got = parity_eval.main(_parity_argv(root, ckpt, root / "dumps"), device="cpu")
    return want, got


def test_parity_eval_matches_jax(parity, files):
    want, got = parity
    assert abs(got - want) < 1e-6, (got, want)
    root, _ = files
    assert sorted(os.listdir(root / "dumps")) == sorted(os.listdir(root / "jax_dumps"))


@pytest.mark.parametrize("gt_raw", [True, False])
def test_evaluate_preds_gives_the_testers_miou(parity, files, gt_raw, capsys):
    root, _ = files
    _, tester = parity
    gt_dir = root / "nyu" / "val_label" if gt_raw else root / "gt_train"
    argv = [str(root / "dumps"), str(gt_dir)] + (["--gt_raw"] if gt_raw else [])
    capsys.readouterr()
    got = evaluate_preds.main(argv, device="cpu")
    port_out = capsys.readouterr().out
    want = jax_evaluate_preds.main(argv)
    assert got == want == tester
    assert port_out == capsys.readouterr().out  # the same table, line for line
    assert f"evaluated {N} images" in port_out


def test_make_result_sheet_matches_jax(parity, files):
    root, _ = files
    dirs = [str(root / "nyu" / "val_rgb"), str(root / "nyu" / "val_label"), str(root / "dumps")]
    written = make_result_sheet.main(dirs + [str(root / "sheets")])
    jax_make_result_sheet.main(dirs + [str(root / "jax_sheets")])
    assert len(written) == N
    for path in written:
        got = np.asarray(Image.open(path))
        want = np.asarray(Image.open(root / "jax_sheets" / os.path.basename(path)))
        assert got.shape == (H, 3 * W, 3)
        np.testing.assert_array_equal(got, want)


def test_summarize_run_reports_as_jax(tmp_path):
    run = tmp_path / "run"
    adapt_train.main(["synthetic", "synthetic_shifted", "--net", "drn_d_14", "--dtype", "float32",
                      "--batch_size", "2", "--train_img_shape", "32", "24", "--max_samples", "4",
                      "--epochs", "1", "--num_k", "1", "--log_every", "1", "--out_dir", str(run)],
                     device="cpu")
    state, cfg = load_checkpoint(str(run / "last"), device="cpu")
    save_jax_checkpoint(str(run / "last"), state, cfg)
    with open(run / "train_log.jsonl", "a") as f:
        f.write('{"step": 9, "loss_s')  # a torn last line, as a killed run leaves
    got = summarize_run.summarize(str(run)).splitlines()
    want = jax_summarize_run.summarize(str(run)).splitlines()

    def report(lines):
        return [ln for ln in lines if not ln.startswith(("checkpoints:", "resume with:"))]

    assert report(got) == report(want)
    ckpt_lines = [ln for ln in got if ln not in report(got)]
    assert any(ln.startswith("steps logged: 2") for ln in got)
    assert "last.pt" in ckpt_lines[0] and "last.msgpack" in ckpt_lines[0]
    assert ckpt_lines[1] == f"resume with: --resume {run / 'last'}"
    with open(run / "args.json") as f:
        assert json.load(f)["model"]["net"] == "drn_d_14"
