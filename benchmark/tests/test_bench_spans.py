"""The readers of the program's spans and counters (``lib/spans.py`` and the
metrics that use it) on synthetic record stores, and one on the program's
own store, on the CPU.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

from __future__ import annotations

import sys
import types

import pytest

from benchmark.lib import spans
from benchmark.lib import spec as specs

TRAIN, SERVE = "drn_d_38_rgbhha.train_b24", "drn_d_38_rgbhha.serve_b8"
RGB = "drn_d_105_rgb.train_1024x512_b16"
NEW = {  # metric: its cells
    "upsample_span_ms.train": [TRAIN, RGB],
    "upsample_span_ms.serve": [SERVE],
    "hha_ms.train": [TRAIN],
    "hha_ms.serve": [SERVE],
    "enqueue_ms.serve": [SERVE],
    "blocking_copies.train": [TRAIN, RGB],
    "blocking_copies.serve": [SERVE],
}


class Store:
    """A synthetic record store in the program's format."""

    def __init__(self):
        self.records = []

    def span(self, name, root, parent=None, host=1.0, device=1.0, backward=False):
        rid = len(self.records)
        self.records.append({"kind": "span", "id": rid, "name": name,
                             "root": rid if root == "self" else root, "parent": parent,
                             "backward": backward, "thread": 1, "start_ns": 0,
                             "end_ns": 1, "host_ms": host, "device_ms": device})
        return rid

    def count(self, name, root, n=1):
        self.records.append({"kind": "count", "id": len(self.records), "name": name,
                             "count": n, "root": root, "parent": root, "thread": 1})

    def stretch(self, kind, roots, ms, hha=True, copies=6):
        """``roots`` roots of ``kind``, each with two upsample spans (forward
        and backward) of ``ms`` device ms and host ms, an HHA span of 2 x
        ``ms`` (where ``hha``) and ``copies`` blocking copies, each inside a
        ``host_wait`` span of ``ms`` / 2."""
        for _ in range(roots):
            r = self.span(spans.ROOTS[kind], "self", host=10 * ms, device=10 * ms)
            for backward in (False, True):
                self.span("upsample", r, r, ms, ms, backward)
            if hha:
                self.span("hha", r, r, 2 * ms, 2 * ms)
            for _ in range(copies):
                self.count("h2d_blocking", r)
                self.span("host_wait", r, r, ms / 2, ms / 2)
                self.count("h2d_bytes", r, 64)


def _record(kind, n, traced=True):
    count = "iterations" if kind == "train" else "requests"
    return {"traffic": {"kind": kind}, "trace": {count: n} if traced else None}


@pytest.fixture
def store(monkeypatch):
    s = Store()
    monkeypatch.setattr(spans, "records", lambda: list(s.records))
    return s


def _read(name, record):
    return specs.reader(name).read(record)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_readers_take_the_first_stretch_and_divide_by_its_roots(store, kind):
    store.stretch(kind, 3, ms=2.0)  # the stretch that traced the device alone
    store.stretch(kind, 3, ms=7.0, copies=9)  # the stretch that traced the host too
    store.span("hha", None)  # outside any root
    rec = _record(kind, 3)
    assert _read(f"upsample_span_ms.{kind}", rec) == pytest.approx(4.0)
    assert _read(f"hha_ms.{kind}", rec) == pytest.approx(4.0)
    assert _read(f"blocking_copies.{kind}", rec) == pytest.approx(6.0)
    if kind == "serve":
        # the entry's host ms less its waits: 10 x 2.0 - 6 x 1.0
        assert _read("enqueue_ms.serve", rec) == pytest.approx(14.0)
    # a trace's count above the roots recorded: per root, not per count
    assert _read(f"upsample_span_ms.{kind}", _record(kind, 10)) == pytest.approx(
        (3 * 4.0 + 3 * 14.0) / 6)


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_read_none_untraced_or_from_an_empty_store(store, name):
    kind = "serve" if name.endswith(".serve") else "train"
    assert _read(name, _record(kind, 3, traced=False)) is None
    assert _read(name, _record(kind, 3)) is None  # the store holds nothing
    store.stretch(kind, 3, ms=1.0)
    other = "train" if kind == "serve" else "serve"
    assert _read(name, _record(other, 3)) is None  # another kind of cell


def test_a_cell_without_the_span_reads_none_never_zero(store):
    store.stretch("train", 3, ms=1.0, hha=False, copies=0)
    rec = _record("train", 3)
    assert _read("hha_ms.train", rec) is None
    assert _read("upsample_span_ms.train", rec) == pytest.approx(2.0)
    assert _read("blocking_copies.train", rec) == 0  # roots that made no copy


@pytest.mark.parametrize("module", [None, types.ModuleType("profiler")],
                         ids=["not_loaded", "without_spans"])
def test_a_program_without_spans_reads_none(monkeypatch, module):
    monkeypatch.setitem(sys.modules, spans.PROFILER, module)
    assert spans.records() == []
    assert _read("upsample_span_ms.serve", _record("serve", 3)) is None


@pytest.mark.parametrize("dropped", [0, 1])
def test_a_store_that_dropped_records_reads_none(monkeypatch, dropped):
    """Past the store's bound a root lacks records: no reader divides a
    short store."""
    s = Store()
    s.stretch("serve", 3, ms=2.0)
    module = types.ModuleType("profiler")
    module.span_records = lambda: list(s.records)
    module.dropped_spans = lambda: dropped
    monkeypatch.setitem(sys.modules, spans.PROFILER, module)
    for name in ("upsample_span_ms.serve", "enqueue_ms.serve", "blocking_copies.serve"):
        got = _read(name, _record("serve", 3))
        assert (got is None) == bool(dropped), name


def test_the_programs_own_store_is_read():
    """Two requests of a tiny drn_d_22 RGB+HHA serving entry under the
    profiler on the CPU: the serving entry's host time per request."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.models.factory import init_models
    from mcseg_tpu_torch.utils import profiler

    cfg = ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=6, n_class=40, dtype="float32"),
        data=DataConfig(src_dataset="suncg", tgt_dataset="nyu", batch_size=1,
                        test_img_shape=(32, 24), input_ch=6, hha_on_device=True))
    serve = make_serve_fn(cfg, init_models(cfg.model, torch.Generator().manual_seed(0)), "cpu")
    r = np.random.RandomState(0)
    request = {"image": r.randint(0, 255, (1, 24, 32, 3)).astype(np.uint8),
               "depth": (r.rand(1, 24, 32) * 3 + 0.5).astype(np.float32)}
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            serve(request)
    try:
        rec = _record("serve", 2)
        assert _read("enqueue_ms.serve", rec) > 0
        assert _read("hha_ms.serve", rec) is None  # no device time off the card
        assert _read("blocking_copies.serve", rec) == 0  # the CPU copies nothing
    finally:
        profiler.reset_spans()


def test_the_new_entries_are_in_the_manifest():
    spec = specs.benchmark_json()
    entries = {m["name"]: m for m in spec["per_layer"]}
    names = [m["name"] for m in spec["per_layer"]]
    assert names[-len(NEW):] == list(NEW)  # appended, in this order
    for name, cells in NEW.items():
        m = entries[name]
        assert m["workloads"] == cells and m["better"] == "lower"
        assert m["source"] == ("program_counter" if name.startswith("blocking")
                               else "program_span")
        r = specs.reader(name)
        assert (r.UNIT, r.LAYER, r.MOVES) == (m["unit"], m["layer"], m["moves"])
