"""The benchmark's arithmetic on the CPU: the FLOP count against PyTorch's
own counter, the byte count, the union of busy intervals, the idle share,
the roofline share and the upsample's kernels found by their operators.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.lib import flops, spec, trace
from benchmark.reference import drn
from benchmark.reference.drn import build_models
from benchmark.reference.mcd import MCD

SMALL = {"channels": [16, 32, 64, 128, 256, 512, 512, 512], "n_class": 7, "dtype": "float32"}


@pytest.mark.parametrize("block,layers,input_ch", [
    ("basic", [1, 1, 2, 2, 2, 2, 1, 1], 6), ("bottleneck", [1, 1, 3, 4, 6, 3, 1, 1], 3)])
@pytest.mark.parametrize("hw", [(48, 64), (50, 70)])
def test_flops_equal_flop_counter_mode(block, layers, input_ch, hw, monkeypatch):
    """The count from shapes equals ``FlopCounterMode`` over the reference's
    MCD iteration (which takes exactly the gradients the count names; its
    checkpointing off, since the count leaves recomputation out) and over
    one served forward, on the ``meta`` device."""
    monkeypatch.setattr(drn, "CHECKPOINT", False)
    model = {**SMALL, "block": block, "layers": layers, "input_ch": input_ch}
    tr = {"lr": 1e-3, "lr_power": 0.9, "max_steps": 10, "momentum": 0.9,
          "weight_decay": 0.0, "num_k": 2}
    with torch.device("meta"):
        g, f1, f2 = build_models(model)
    x = torch.empty((2, input_ch) + hw, device="meta")
    y = torch.zeros((2,) + hw, dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        MCD(g, f1, f2, tr).iteration(x, y, x)
    want = flops.train_flops(model, 2, 2, hw)
    assert counter.get_total_flops() == want["total"]
    assert sum(counter.get_flop_counts()["DRN"].values()) == want["trunk"]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        f1(g(x))
    assert counter.get_total_flops() == flops.serve_flops(model, 2, hw)


def test_cell_counts():
    """DRN-D-38's trunk in a batch-8 640x480 iteration: the 35.26 TFLOP
    counted over the program's trunk when the port was written, within 3%;
    the heads add 0.2%. The cells: 105.99 and 123.12 TFLOP an iteration,
    2.083 a served request."""
    m38, m105 = (spec.config(n)["model"] for n in ("drn_d_38_rgbhha", "drn_d_105_rgb"))
    f = flops.train_flops(m38, 4, 8, (480, 640))
    assert abs(f["trunk"] / 35.26e12 - 1) < 0.03
    assert 0 < f["total"] - f["trunk"] < 0.01 * f["total"]
    assert round(flops.train_flops(m38, 4, 24, (480, 640))["total"] / 1e12, 2) == 105.99
    assert round(flops.train_flops(m105, 4, 8, (512, 1024))["total"] / 1e12, 2) == 123.12
    assert round(flops.serve_flops(m38, 8, (480, 640)) / 1e12, 3) == 2.083


def test_normalize_bytes():
    # float32 crops and HHA/255 read once, the bf16 stack written once
    assert abs(flops.normalize_stack_bytes(24, (480, 640), 6, 4) / 1e6 - 265.4) < 0.1
    assert flops.normalize_stack_bytes(8, (512, 1024), 3, 4) == \
        8 * 512 * 1024 * (3 * 4 + 3 * 2) + 8 * 4


def test_union_of_busy_intervals():
    got = trace.merge([(5.0, 6.0), (0.0, 1.0), (0.5, 2.0), (2.0, 3.0), (4.0, 4.5)])
    assert got == [(0.0, 3.0), (4.0, 4.5), (5.0, 6.0)]
    assert sum(b - a for a, b in got) == 4.5


def _record(kind, **trace_fields):
    base = {"busy_s": 4.5, "window_s": 6.0, "upsample_s": 0.3, "ops": {},
            "iterations": 3, "requests": 3}
    return {"traffic": {"kind": kind, "batch": 24,
                        "scene": {"height": 480, "width": 640}},
            "config": {"model": {"input_ch": 6}},
            "trace": {**base, **trace_fields},
            "window": {"window_s": 10.0, "flops": 989e12}}


def test_busy_seconds_of_made_up_device_rows():
    """The device-only stretch's busy time: the union of the CUDA rows'
    intervals (microseconds in, seconds out); host rows and user
    annotations do not count."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(kind, start, end):
        return SimpleNamespace(device_type=kind, time_range=SimpleNamespace(start=start, end=end))

    events = [row(cuda, 0, 100), row(cuda, 50, 150), row(cuda, 300, 400), row(cpu, 0, 1000)]
    assert trace.busy_seconds(events) == pytest.approx(250e-6)
    annotation = row(cuda, 0, 400)
    annotation.is_user_annotation = True  # a range on the device's timeline, gaps and all
    assert trace.busy_seconds(events + [annotation]) == pytest.approx(250e-6)
    assert trace.busy_seconds([row(cpu, 0, 10)]) == 0


def test_readers_on_made_up_records():
    rd = spec.reader
    assert rd("idle_share.train").read(_record("train")) == pytest.approx(25.0)
    assert rd("idle_share.serve").read(_record("train")) is None
    assert rd("upsample_ms.train").read(_record("train")) == pytest.approx(100.0)
    assert rd("upsample_ms.serve").read(_record("serve")) == pytest.approx(100.0)
    assert rd("upsample_ms.train").read(_record("train", upsample_s=0.0)) is None
    assert rd("mfu.train").read(_record("train")) == pytest.approx(10.0)
    nbytes = flops.normalize_stack_bytes(24, (480, 640), 6, 4)
    # two launches taking exactly twice the bound: 50%
    seconds = 2 * 2 * nbytes / 3.35e12
    rec = _record("train", ops={"void normalize_stack_kernel<float, bf16, 6, 3>": [seconds, 2]})
    assert rd("normalize_stack_roofline.train").read(rec) == pytest.approx(50.0)
    assert rd("normalize_stack_roofline.train").read(_record("train")) is None
    rec = _record("serve", ops={"Memcpy HtoD (Pageable -> Device)": [0.006, 3],
                                "Memcpy DtoH (Device -> Pageable)": [0.003, 3]})
    assert rd("copy_ms.serve").read(rec) == pytest.approx(3.0)


def _event(name, seq=-1, kernels=(), children=()):
    return SimpleNamespace(name=name, sequence_nr=seq, cpu_children=list(children),
                           kernels=[SimpleNamespace(duration=d) for d in kernels])


def test_upsample_kernels_found_by_operator():
    """The transposed conv's forward and the backward nodes that carry its
    sequence numbers, with the kernels of the operations under them
    (microseconds), each kernel once; other convolutions' kernels are left
    out."""
    inner = _event("aten::_convolution", kernels=[1000.0])
    conv = _event("aten::convolution", seq=7, children=[inner])
    fwd = _event("aten::conv_transpose2d", seq=7, children=[conv])
    zero = _event("aten::zero_", kernels=[10.0])
    bwd_op = _event("aten::convolution_backward", kernels=[5000.0], children=[zero])
    bwd = _event("ConvolutionBackward0", seq=7, children=[bwd_op])
    wrap = _event("autograd::engine::evaluate_function: ConvolutionBackward0", seq=7,
                  children=[bwd])
    other_op = _event("aten::convolution_backward", kernels=[700.0])
    other = _event("ConvolutionBackward0", seq=3, children=[other_op])
    score = _event("aten::conv2d", seq=3, kernels=[300.0])
    events = [fwd, conv, inner, wrap, bwd, bwd_op, zero, other, other_op, score]
    assert trace.upsample_seconds(events) == pytest.approx((1000.0 + 5000.0 + 10.0) * 1e-6)
