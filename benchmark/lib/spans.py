"""The program's own spans and counters (``mcseg_tpu_torch/utils/profiler.py``)
as the per-layer readers read them.

The program records its spans and counters only while a ``torch.profiler``
session records, and keeps them in memory until they are read. In a run the
profiler records only in the two traced stretches after the window: the
first traces the device's activity alone, the second the host's operations
too. Each training iteration is a root span ``train.iteration``, each served
request a root span ``serve.request``, and every record carries its root.
A reader takes the first ``trace["iterations"]`` (``trace["requests"]``)
roots, the first stretch's, where host tracing does not slow the host
(where a session tracing the device alone turned no span on, those are the
second stretch's), and divides by the roots it found. A run without
``--trace 1``, or of a program that has no spans, reads no record, and the
reader returns None; so does a run whose store dropped records past its
bound. The readers load nothing of the program: they read the store of the
profiler module that the program loaded in this process.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

ROOTS = {"train": "train.iteration", "serve": "serve.request"}
PROFILER = "mcseg_tpu_torch.utils.profiler"  # the program's module that keeps the store


def records() -> List[Dict]:
    """The program's records; [] where the program loaded no profiler
    module that keeps spans, and where its store's bound dropped records
    (a root would then lack spans or counts, and read short)."""
    module = sys.modules.get(PROFILER)
    span_records = getattr(module, "span_records", None)
    if span_records is None or module.dropped_spans():
        return []
    return span_records()


def first_roots(record) -> Optional[Tuple[int, List[Dict]]]:
    """(the number of roots read, the records that lie in them) of the
    first traced stretch, or None where the run recorded no root."""
    trace = record["trace"]
    if trace is None:
        return None
    kind = record["traffic"]["kind"]
    n = trace["iterations"] if kind == "train" else trace["requests"]
    recs = records()
    roots = {r["id"] for r in recs if r["kind"] == "span" and r["name"] == ROOTS[kind]
             and r["root"] == r["id"]}
    first = set(sorted(roots)[:n])
    if not first:
        return None
    return len(first), [r for r in recs if r["root"] in first]


def span_ms_per_root(record, name: str, field: str = "device_ms") -> Optional[float]:
    """The sum of ``field`` (``device_ms``: CUDA event to CUDA event;
    ``host_ms``) over the spans ``name``, forward and backward, per root;
    None where the roots hold no such span."""
    got = first_roots(record)
    if got is None:
        return None
    n, recs = got
    values = [r[field] for r in recs if r["kind"] == "span" and r["name"] == name]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / n


def count_per_root(record, name: str) -> Optional[float]:
    """The counter ``name``'s increments per root (0 where the roots hold
    none); None where the run recorded no root."""
    got = first_roots(record)
    if got is None:
        return None
    n, recs = got
    return sum(r["count"] for r in recs if r["kind"] == "count" and r["name"] == name) / n
