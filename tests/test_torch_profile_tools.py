"""The port's profiling tools (``mcseg_tpu_torch/utils/profiler.py``,
``tools/profile_step.py``, ``tools/profile_input_pipeline.py``) against the
JAX package's, on the CPU at tiny shapes.

``time_step``: the same calls, in the same order and with the same state
threading, as JAX's on one plain-Python step. ``profile_input_pipeline``:
JAX's test's arguments (a 6-image 64x32 synthetic corpus, batch 2, 2
workers, 2 windows of 2 steps); every stage line, and no decode in the
timed windows, which the port's locked disk-cache open makes independent
of thread timing; its ``_synth_corpus`` decodes to JAX's arrays.
``profile_step``: one traced MCD iteration of drn_d_22 RGB+HHA at 32x32,
batch 2, ``num_k`` 1, on the CPU when asked (``device="cpu"``): the
category table with the normalize kernel's plain version called twice per
step, the categories adding up to the total, then the table of the
program's spans (one ``train.iteration`` a step, 8 ``upsample`` forward and
backward at ``num_k`` 1) and its counters; without ``device`` it needs a
card.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mcseg_tpu.tools import profile_input_pipeline as jax_pipeline
from mcseg_tpu.utils import profiler as jax_profiler
from mcseg_tpu_torch.tools import profile_input_pipeline, profile_step
from mcseg_tpu_torch.utils import profiler
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

STEP_ARGV = ["--net", "drn_d_22", "--img", "32", "32", "--batch", "2", "--steps", "1",
             "--num_k", "1"]
STAGES = ("has_many", "get_many[image  ]", "get_many[label  ]", "get_many[depth  ]",
          "get_many (all)", "ds.get_batch", "zip.get_batch", "wire_format(src)",
          "wire_format(tgt,dl)", "batch_iterator steady state", "io_stats src:")


@pytest.mark.parametrize("threading", [True, False], ids=["state_threading", "plain"])
def test_time_step_calls_and_threads_like_jax(threading):
    def run(time_step):
        calls = []

        def step(state, x, scale=1):
            calls.append((state, x, scale))
            return (state + x * scale, state) if threading else state + x

        out = time_step(step, 10, 3, iters=4, items_per_call=8, scale=2)
        return calls, out

    got_calls, got = run(profiler.time_step)
    want_calls, want = run(jax_profiler.time_step)
    assert got_calls == want_calls and len(got_calls) == 5  # one warm-up, 4 timed
    if threading:
        assert [c[0] for c in got_calls] == [10, 16, 22, 28, 34]
    assert got.keys() == want.keys() == {"sec_per_iter", "items_per_sec"}
    assert got["items_per_sec"] == pytest.approx(8 / got["sec_per_iter"])


def test_synth_corpus_decodes_to_the_jax_tool_corpus(tmp_path):
    jax_pipeline._synth_corpus(str(tmp_path / "jax"), 3, 24, 16)
    profile_input_pipeline._synth_corpus(str(tmp_path / "port"), 3, 24, 16)
    for sub in ("train_rgb", "train_label", "train_depth"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and len(names) == 3
        for name in names:
            a = np.asarray(Image.open(tmp_path / "jax" / sub / name))
            b = np.asarray(Image.open(tmp_path / "port" / sub / name))
            assert a.dtype == b.dtype and np.array_equal(a, b), (sub, name)


def test_profile_input_pipeline_serves_the_timed_windows_from_disk(tmp_path, capsys):
    got = profile_input_pipeline.main([
        "--data_root", str(tmp_path / "c"), "--synth", "6", "--batch", "2",
        "--img_shape", "64x32", "--num_workers", "2", "--windows", "2",
        "--steps_per_window", "2"])
    out = capsys.readouterr().out
    for stage in STAGES:
        assert stage in out, stage
    assert "timed-window decodes: 0" in out and got["timed_window_decodes"] == 0
    assert got["io_stats"]["src"]["disk_hits"] > 0 and len(got["steady_img_per_s"]) == 2


def test_profile_step_on_the_cpu_prints_the_category_table(tmp_path, capsys):
    got = profile_step.main(STEP_ARGV + ["--trace_dir", str(tmp_path / "trace")],
                            device="cpu")
    out = capsys.readouterr().out
    assert got["time"] == "cpu_self" and got["steps"] == 1
    cats = got["categories"]
    assert list(cats) == ["normalize_stack", "collectives", "batch_norm", "conv", "copies",
                          "other"]
    assert cats["normalize_stack"]["calls"] == 2  # source and target batch
    assert cats["conv"]["ms"] > 0 and cats["batch_norm"]["calls"] > 0
    total = sum(c["ms"] for c in cats.values())
    assert total == pytest.approx(got["total_ms"], rel=1e-9)
    assert sum(c["share"] for c in cats.values()) == pytest.approx(1.0, rel=1e-9)
    assert "CAT" in out and "normalize_stack" in out and "--- top ops ---" in out
    assert "traced; loss_source" in out and np.isfinite(got["loss_source"])
    assert os.path.getsize(got["trace"]) > 0
    spans = got["spans"]
    assert "--- spans (per step) ---" in out and "SPAN" in out and "upsample.backward" in out
    assert list(spans)[:3] == ["train.iteration", "train.preprocess", "train.draws"]
    assert spans["train.iteration"]["calls"] == 1 and spans["hha"]["calls"] == 2
    assert spans["upsample"]["calls"] == spans["upsample.backward"]["calls"] == 8
    assert {"mcd.step_a", "mcd.step_b", "mcd.step_c"} <= set(spans)
    assert all(s["host_ms"] > 0 and s["device_ms"] is None for s in spans.values())
    assert not any(r["name"].startswith("mcseg::train") for r in got["rows"])
    assert got["counters"] == {}  # the CPU makes no host-to-card copy


def test_profile_step_without_a_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_step.main(STEP_ARGV + ["--trace_dir", str(tmp_path / "trace")])
    assert not os.path.exists(tmp_path / "trace")  # refused before any work
