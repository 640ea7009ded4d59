"""On the card: a tiny traced run of each kind reads its trace. The profiler
finds device time, the upsample's kernels by their operators, the
normalize kernel under its roofline, and the check still passes.

    python -m pytest benchmark/tests/test_bench_cuda.py -q     (on the card)
"""

from __future__ import annotations

import pytest

from benchmark.tests import _tiny


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the trace's device rows exist only there")


@pytest.fixture(scope="module")
def checkout(card, tmp_path_factory):
    return _tiny.make_checkout(str(tmp_path_factory.mktemp("tiny")), dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [_tiny.TRAIN_CELL, _tiny.RGB_CELL, _tiny.SERVE_CELL])
def test_traced_run_reads_its_trace(checkout, cell):
    out = _tiny.run_cell(checkout, cell, trace=1, device="cuda")
    dev, metrics = out["device"], out["metrics"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert out["breakdown"]["device_ops"]
    kind = "serve" if cell == _tiny.SERVE_CELL else "train"
    assert metrics[f"upsample_ms.{kind}"]["value"] > 0
    assert 0 <= metrics[f"idle_share.{kind}"]["value"] < 100
    if kind == "train":
        assert 0 < metrics["normalize_stack_roofline.train"]["value"] <= 105
        assert metrics["preprocess_ms.train"]["value"] > 0
        assert metrics["step_c_ms.train"]["value"] > 0
    else:
        assert metrics["copy_ms.serve"]["value"] > 0
