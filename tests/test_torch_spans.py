"""The port's spans and counters (``mcseg_tpu_torch/utils/profiler.py``
``span``, ``backward_span``, ``count``, ``core/device.py to_device``) on the
CPU: drn_d_22, RGB+HHA, 40 classes, batch 2 at 32x24, float32, nothing
written to disk.

Untraced they record nothing and open no ``record_function``. Under
``torch.profiler`` one MCD iteration (``num_k`` 1) and one served request
record the spans of their layers with the expected nesting and roots: the
upsample's forward and backward in steps A (2), B (4) and C (2, through
``torch.autograd.grad``), each backward span around the profiler's
``mcseg::upsample_convt_backward`` of that upsample. The counters count every
host-to-card copy where the card would make it (``to_device``'s test of
the destination is widened to the CPU), by the span the copy lies in, and
each blocking copy and each ``eigh`` lies in a ``host_wait`` span. The
spans change no number: losses, gradients, the state after the iteration
and the served class map are bitwise equal with them on and off. The
store's bound counts what it drops. Spans under spatial partitioning (the
halo exchange) are in ``tests/test_torch_spatial.py``; on the card, the
spans' device times in ``tests/test_torch_cuda.py``.
"""

import collections
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mcseg_tpu_torch.core import device as device_mod
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.core.device import to_device
from mcseg_tpu_torch.eval.serving import make_serve_fn
from mcseg_tpu_torch.train.loops import make_adapt_iteration
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils import profiler
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W = 2, 24, 32
STEP_UPSAMPLES = {"mcd.step_a": 2, "mcd.step_b": 4, "mcd.step_c": 2}
# blocking copies of one iteration by the span they lie in: the draws (3 per
# batch), HHA's first gravity (1 per batch), and in the preprocess the source
# labels' table and the crop positions' scales (the upsample copies nothing:
# its kernel works out its taps)
TRAIN_COPIES = {"train.draws": 6, "hha": 2, "train.preprocess": 5}
# a request: the image and depth planes, HHA's gravity
SERVE_COPIES = {"serve.to_device": 2, "hha": 1}
EIGHS = 3  # HHA's gravity rounds, each an eigh that checks its result on the host


def _cfg(num_k=1):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=6, n_class=40, dtype="float32"),
        data=DataConfig(src_dataset="suncg", tgt_dataset="nyu", batch_size=B,
                        train_img_shape=(W, H), test_img_shape=(W, H), input_ch=6,
                        hha_on_device=True, random_crop=True, crop_scale_min=0.7,
                        random_flip=True),
        train=TrainConfig(lr=1e-3, num_k=num_k, max_steps=100, seed=3))


def _raw(seed):
    r = np.random.RandomState(seed)
    return {"image": torch.from_numpy(r.randint(0, 255, (B, H, W, 3)).astype(np.uint8)),
            "label": torch.from_numpy(r.randint(0, 41, (B, H, W)).astype(np.uint8)),
            "depth": torch.from_numpy(r.rand(B, H, W).astype(np.float32) * 3 + 0.5)}


@pytest.fixture(scope="module")
def setup():
    cfg = _cfg()
    state = create_train_state(cfg.model, cfg.train, 0, "cpu")
    return cfg, state, _raw(0), _raw(1)


@pytest.fixture
def as_card(monkeypatch):
    """``to_device`` counts each copy as it would on the card."""
    monkeypatch.setattr(device_mod, "_host_to_card", lambda t, d: t.device.type == "cpu")
    profiler.reset_spans()
    yield
    profiler.reset_spans()


def _traced(fn, *args):
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, profiler.span_records(), prof.events()


def _spans(records, name=None):
    return [r for r in records if r["kind"] == "span" and name in (None, r["name"])]


def _copies_by_span(records):
    names = {r["id"]: r["name"] for r in _spans(records)}
    out = collections.Counter()
    for r in records:
        if r["kind"] == "count" and r["name"] == "h2d_blocking":
            out[names[r["parent"]]] += r["count"]
    return dict(out)


def _waits_by_span(records, hhas):
    """The ``host_wait`` spans by the span they lie in, beside what each
    blocking copy and each of ``hhas`` HHA calls' eighs imply."""
    names = {r["id"]: r["name"] for r in _spans(records)}
    got = collections.Counter(names[r["parent"]] for r in _spans(records, "host_wait"))
    implied = collections.Counter(_copies_by_span(records))
    implied["hha"] += EIGHS * hhas
    return dict(got), dict(implied)


def test_untraced_spans_and_counts_record_nothing(setup, monkeypatch):
    cfg, state, src, tgt = setup

    def refused(*a, **k):
        raise AssertionError("a record_function opened while no profiler records")

    monkeypatch.setattr(profiler, "record_function", refused)
    monkeypatch.setattr(device_mod, "_host_to_card", lambda t, d: True)
    profiler.reset_spans()
    assert profiler.span("a") is profiler.span("b")  # one shared object, nothing made
    with profiler.span("train.iteration"):
        profiler.count("h2d_blocking")
        to_device(torch.ones(3), "cpu")
    make_adapt_iteration(cfg)(copy.deepcopy(state), src, tgt)
    make_serve_fn(cfg, state.params(), "cpu")({k: v.numpy() for k, v in src.items()})
    assert profiler.span_records() == [] and profiler.dropped_spans() == 0


def test_iteration_spans_nest_and_bracket_the_upsample_backward(setup, as_card):
    cfg, state, src, tgt = setup
    _, records, events = _traced(make_adapt_iteration(cfg), copy.deepcopy(state), src, tgt)
    spans = _spans(records)
    by_id = {r["id"]: r for r in spans}
    (root,) = [r for r in spans if r["name"] == "train.iteration"]
    assert root["root"] == root["id"] and root["parent"] is None
    assert all(r["root"] == root["id"] for r in records)

    def parent(r):
        return by_id[r["parent"]]["name"]

    (pre,) = _spans(records, "train.preprocess")
    assert parent(pre) == "train.iteration"
    draws = _spans(records, "train.draws")
    assert len(draws) == 4 and {parent(r) for r in draws} == {"train.preprocess"}
    assert [parent(r) for r in _spans(records, "hha")] == ["train.preprocess"] * 2
    steps = [r["name"] for r in spans if r["name"].startswith("mcd.")]
    assert steps == list(STEP_UPSAMPLES)
    assert {parent(r) for r in spans if r["name"] in STEP_UPSAMPLES} == {"train.iteration"}
    ups = _spans(records, "upsample")
    fwd = [r for r in ups if not r["backward"]]
    bwd = [r for r in ups if r["backward"]]
    assert len(fwd) == len(bwd) == sum(STEP_UPSAMPLES.values())
    assert collections.Counter(parent(r) for r in fwd) == STEP_UPSAMPLES
    assert sorted(r["parent"] for r in bwd) == sorted(r["id"] for r in fwd)
    assert all(r["host_ms"] >= 0 and r["device_ms"] is None for r in spans)
    # on the profiler's clock: each backward span holds one call of the
    # upsample's gradient op, and every call lies in one
    nodes = [e for e in events if e.name == "mcseg::upsample_convt_backward"]
    marked = [e for e in events if e.name == "mcseg::upsample.backward"]
    assert len(marked) == len(bwd) == len(nodes)
    for m in marked:
        inside = [e for e in nodes if m.time_range.start <= e.time_range.start
                  and e.time_range.end <= m.time_range.end]
        assert len(inside) == 1
    assert _copies_by_span(records) == TRAIN_COPIES
    got, implied = _waits_by_span(records, hhas=2)
    assert got == implied


def test_served_request_spans_and_copies(setup, as_card):
    cfg, state, src, _ = setup
    serve = make_serve_fn(cfg, state.params(), "cpu")
    request = {k: v.numpy() for k, v in src.items() if k != "label"}
    _, records, _ = _traced(serve, request)
    spans = [r for r in _spans(records) if r["name"] != "host_wait"]
    (root,) = _spans(records, "serve.request")
    assert [r["name"] for r in spans] == ["serve.request", "serve.to_device", "hha", "upsample"]
    assert all(r["root"] == root["id"] for r in records)
    assert {r["parent"] for r in spans[1:]} == {root["id"]}
    assert not spans[-1]["backward"]  # inference mode: no backward span
    assert _copies_by_span(records) == SERVE_COPIES
    got, implied = _waits_by_span(records, hhas=1)
    assert got == implied
    moved = sum(r["count"] for r in records if r["name"] == "h2d_bytes")
    assert moved == sum(v.nbytes for v in request.values()) + 3 * 4


def _iteration_numbers(cfg, state, src, tgt):
    state = copy.deepcopy(state)
    first = {}

    def mark(stage):  # the first gradient, from step A's momentum buffers
        if stage == "A":
            first.update({k: v["momentum_buffer"].clone()
                          for k, v in enumerate(state.opt_g.state.values())})

    metrics = make_adapt_iteration(cfg)(state, src, tgt, mark)
    leaves = {f"{n}.{k}": v for n, m in state.modules().items()
              for k, v in m.state_dict().items()}
    return {k: v for k, v in metrics.items() if k != "lr"}, first, leaves


def _served(cfg, state, src):
    request = {k: v.numpy() for k, v in src.items() if k != "label"}
    return {"pred": make_serve_fn(cfg, state.params(), "cpu")(request)}


@pytest.mark.parametrize("path", ["train", "serve"])
def test_spans_change_no_number(setup, path):
    cfg, state, src, tgt = setup
    run = ((lambda: _iteration_numbers(cfg, state, src, tgt)) if path == "train"
           else (lambda: (_served(cfg, state, src),)))
    off = run()
    on, records, _ = _traced(run)
    assert _spans(records)
    for a, b in zip(off, on):
        assert a.keys() == b.keys() and a
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("limit", [0, 4, 100])
def test_the_store_bound_counts_what_it_drops(monkeypatch, limit):
    monkeypatch.setattr(profiler, "MAX_RECORDS", limit)
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiler.span("serve.request"):
                with profiler.span("hha"):
                    profiler.count("h2d_blocking")
    kept, dropped = profiler.span_records(), profiler.dropped_spans()
    profiler.reset_spans()
    assert [r["name"] for r in kept] == (["serve.request", "hha", "h2d_blocking"] * 2)[:limit]
    assert dropped == 6 - len(kept) and profiler.dropped_spans() == 0


@pytest.mark.parametrize("dest,blocking", [("meta", 1), ("cpu", 0)])
def test_to_device_counts_a_copy_to_another_device(dest, blocking):
    t = torch.ones(5, dtype=torch.float64)
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("serve.request"):
            out = to_device(t, dest, torch.float32)
    records = profiler.span_records()
    profiler.reset_spans()
    assert out.device.type == dest and out.dtype == torch.float32
    counts = {r["name"]: r["count"] for r in records if r["kind"] == "count"}
    # a blocking copy converts on the host: float32's bytes move
    assert counts == ({"h2d_bytes": 20, "h2d_blocking": 1} if blocking else {})
    assert len(_spans(records, "host_wait")) == blocking
