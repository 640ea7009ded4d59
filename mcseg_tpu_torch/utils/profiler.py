"""Profiling hooks: a trace context manager, a step timer, and the
program's spans and counters.

The port of the JAX package's ``utils/profiler.py``. ``trace`` records a
``torch.profiler`` trace (host operators and, on the card, its kernels and
copies) and writes it as a Chrome/Perfetto trace file; ``time_step`` times
a step with its warm-up excluded and returns the rate, the BASELINE
metric.

Spans and counters mark the program's layers (``span``, ``backward_span``,
``count``). They act only while a ``torch.profiler`` session records
(``torch._C._autograd._profiler_enabled``); otherwise ``span`` returns one
shared object that does nothing, and ``count`` returns at once. An active
span enters ``record_function("mcseg::<name>")``, so it lies in the
profiler's own trace on the kernels' clock; on a card it records a CUDA
timing event on the current stream at entry and at exit; it reads
``time.perf_counter_ns`` at both; and it keeps one record in memory.
Records go into a bounded list (``MAX_RECORDS``; those past it are counted
in ``dropped_spans``), nothing is written during a run, and
``span_records`` resolves the events once, after one synchronize. A span
named in ``ROOTS`` (one training iteration, one served request) is a root:
every record and counter increment carries the id of the root it lies in,
so "per iteration" and "per request" are counts of the program's own.

The spans and where they open:

  train.iteration   (root) train/loops.py, each trainer's ``iterate``
  train.preprocess  both batches' train preprocess, up to ``mark("preprocess")``
  train.draws       the crop and flip draws and their copy to the card
  mcd.step_a/b/c    train/mcd.py, the bounds of the marks A, B, C
  hha               ops/hha.py ``depth_to_hha_batch``
  upsample          ops/upsample.py ``upsample_logits``, forward and backward
  serve.request     (root) eval/serving.py ``make_serve_fn``'s ``serve``
  serve.to_device   eval/tester.py ``batch_to_device``
  host_wait         every call in which the host waits for the card: a
                    blocking copy to it (``core/device.py to_device``) and
                    ``torch.linalg.eigh``, which checks its result on the host

and the counters: ``h2d_bytes`` and ``h2d_blocking``, the bytes of every
host-to-card copy the program makes and the copies the host waits for
(``core/device.py to_device``), and ``upsample_kernel``, each launch of the
upsample's kernels, forward or backward (``ops/upsample.py``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_DIR = os.path.join(tempfile.gettempdir(), "mcseg_trace")


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str = TRACE_DIR) -> Iterator[profile]:
    """Record the block under ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``log_dir/trace.json``, which Perfetto and
    ``chrome://tracing`` open; yields the profiler, whose
    ``key_averages()`` summarize the block (``tools.profile_step.summarize``)."""
    with profile(activities=_activities()) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _block_until_ready(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor (JAX's
    ``block_until_ready``); host results are ready already."""
    tensors = out if isinstance(out, (tuple, list)) else (
        list(out.values()) if isinstance(out, dict) else [out])
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def time_step(step_fn: Callable, *args, iters: int = 10, items_per_call: int = 1,
              **kwargs) -> dict:
    """Time a step: one warm-up call, then ``iters`` timed calls.

    The step is taken as state-threading (the first result becomes the
    first argument of the next call) when its result is a tuple; otherwise
    the outputs are only waited for. Returns ``sec_per_iter`` and
    ``items_per_sec``."""
    out = step_fn(*args, **kwargs)
    state_threading = isinstance(out, tuple) and len(args) >= 1
    _block_until_ready(out)
    if state_threading:
        args = (out[0],) + args[1:]

    t0 = time.perf_counter()
    for _ in range(iters):
        out = step_fn(*args, **kwargs)
        if state_threading:
            args = (out[0],) + args[1:]
    _block_until_ready(out)
    dt = time.perf_counter() - t0
    return {
        "sec_per_iter": dt / iters,
        "items_per_sec": items_per_call * iters / dt,
    }


# ---- spans and counters -----------------------------------------------------

ROOTS = ("train.iteration", "serve.request")
MAX_RECORDS = 1 << 16
PREFIX = "mcseg::"
_recording = torch._C._autograd._profiler_enabled


class _Store:
    """The records of this process in the order they were made: a span's
    when it opens, a counter's at its increment."""

    def __init__(self):
        self.records: List[Dict] = []
        self.dropped = 0
        self.ids = itertools.count()

    def add(self, record: Dict) -> bool:
        if len(self.records) >= MAX_RECORDS:
            self.dropped += 1
            return False
        self.records.append(record)
        return True


_store = _Store()
_local = threading.local()

# (id, root id) of a span
Ident = Tuple[int, Optional[int]]


def _stack() -> List[Ident]:
    """This thread's open spans, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    """An active span. ``outer`` is the span it lies in (by default this
    thread's innermost open span); a backward span passes its forward's."""

    __slots__ = ("name", "backward", "outer", "ident", "record", "_rf")

    def __init__(self, name: str, backward: bool = False, outer: Optional[Ident] = None):
        self.name, self.backward, self.outer = name, backward, outer

    def __enter__(self) -> "_Span":
        stack = _stack()
        outer = self.outer if self.outer is not None else (stack[-1] if stack else None)
        sid = next(_store.ids)
        root = sid if self.name in ROOTS and not self.backward else (outer and outer[1])
        self.ident = (sid, root)
        self._rf = record_function(PREFIX + self.name + (".backward" if self.backward else ""))
        self._rf.__enter__()
        self.record = {"kind": "span", "id": sid, "name": self.name, "root": root,
                       "parent": outer and outer[0], "backward": self.backward,
                       "thread": threading.get_ident(), "start_ns": 0, "end_ns": None,
                       "host_ms": None, "device_ms": None, "_events": None}
        if _store.add(self.record) and torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
            self.record["_events"] = events
        stack.append(self.ident)
        self.record["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        r = self.record
        r["end_ns"] = time.perf_counter_ns()
        r["host_ms"] = (r["end_ns"] - r["start_ns"]) * 1e-6
        if r["_events"] is not None:
            r["_events"][1].record()
        stack = _stack()
        if stack and stack[-1] is self.ident:
            stack.pop()
        elif self.ident in stack:
            stack.remove(self.ident)
        self._rf.__exit__(None, None, None)
        return False


class _Off:
    """The span of a process that no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str):
    """A context manager marking the layer ``name`` while a profiler
    records; otherwise one shared object that does nothing."""
    if not _recording():
        return _OFF
    return _Span(name)


def backward_span(name: str, out: torch.Tensor, inp: torch.Tensor) -> None:
    """Mark autograd's backward from ``out`` to ``inp`` (the work of the op
    that made ``out`` from ``inp``) as a span ``name`` with ``backward``
    set: it opens when the gradient of ``out`` is ready (a hook on
    ``out``) and closes when the gradient of ``inp`` is (a hook on
    ``inp``), and keeps the root of the span this is called in. The hooks
    are registered only while a profiler records and the backward exists
    (grad mode, both tensors in the graph)."""
    if not (_recording() and torch.is_grad_enabled() and out.requires_grad
            and inp.requires_grad):
        return
    stack = _stack()
    outer = stack[-1] if stack else None
    opened: List[_Span] = []

    def start(grad):
        opened.append(_Span(name, backward=True, outer=outer).__enter__())

    def end(grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    out.register_hook(start)
    inp.register_hook(end)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records: one
    record, tagged with the innermost open span (``parent``) and its
    root."""
    if not _recording():
        return
    stack = _stack()
    outer = stack[-1] if stack else None
    _store.add({"kind": "count", "id": next(_store.ids), "name": name, "count": n,
                "root": outer and outer[1], "parent": outer and outer[0],
                "thread": threading.get_ident()})


def count_copy(t: torch.Tensor, non_blocking: bool = False,
               dtype: Optional[torch.dtype] = None) -> bool:
    """Count a copy of the host tensor ``t`` to the card, as ``t.to(card,
    dtype, non_blocking)`` makes it: the bytes it moves in ``h2d_bytes``
    (``dtype``'s where a blocking copy converts on the host first), and one
    ``h2d_blocking`` where the host waits for it (it is not
    ``non_blocking``, or its source is not pinned). Returns whether it
    counted a copy the host waits for."""
    if not _recording():
        return False
    itemsize = dtype.itemsize if dtype is not None and not non_blocking else t.element_size()
    count("h2d_bytes", t.numel() * itemsize)
    blocking = not (non_blocking and t.is_pinned())
    if blocking:
        count("h2d_blocking")
    return blocking


def span_records() -> List[Dict]:
    """The finished spans and the counter increments, in the order they
    were made, each a dict: ``kind`` ("span" or "count"), ``id``,
    ``name``, ``root`` (the id of its root span, None outside any),
    ``parent`` (the enclosing span's id; a backward span's is its
    forward's), ``thread``; a span's ``backward``, ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), ``host_ms`` and ``device_ms``
    (CUDA event to CUDA event; None off the card); a counter's ``count``.
    Synchronizes the card once to resolve the events."""
    records = list(_store.records)
    pending = [r for r in records if r["kind"] == "span" and r["_events"] is not None
               and r["end_ns"] is not None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            start, end = r["_events"]
            r["device_ms"], r["_events"] = start.elapsed_time(end), None
    return [{k: v for k, v in r.items() if k != "_events"} for r in records
            if r["kind"] == "count" or r["end_ns"] is not None]


def dropped_spans() -> int:
    """Records the bound (``MAX_RECORDS``) kept out since the last reset."""
    return _store.dropped


def reset_spans() -> None:
    """Empty the store."""
    global _store
    _store = _Store()
