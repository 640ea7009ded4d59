"""Reduction of a ``torch.profiler`` trace to what the per-layer readers
read: the device's busy intervals and their union, the device time and
count of each operation by name, and the idle gaps named by what the host
was doing.

Device rows are those whose ``device_type`` is CUDA (kernels, copies,
sets), user annotations left out. Their union is the device's busy time; everything else in the
traced stretch's wall time is idle. A run traces two stretches of the same
work: one with the device's activity alone (``busy_seconds``), whose idle
share is the device's, and one with the host's operations too
(``reduce_profile``), whose host bookkeeping slows the host down but names
the gaps and links kernels to operators. A gap is named by the two
innermost host operations that cover its middle (``aten::copy_ >
cudaMemcpyAsync``), or "host: none" where no traced host operation covers
it.

The heads' upsample is found by its operator: every ``aten::conv_transpose2d``
(the program's only transposed conv is the heads' 8x upsample) and the
``ConvolutionBackward0`` that autograd runs for it, which carries the
forward's sequence number, each with the device kernels that it and the
operations under it launched (the profiler links each kernel to the
operation that launched it). Recording operator shapes instead would cost
the host enough in a cell of many small operations to idle the card.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, List, Tuple

import torch

TOP = 10


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def _host_labels(host: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each time in ``points`` (ascending), the label of the host
    operations covering it: a sweep over the operations by start time with
    the open ones in a heap by end time."""
    host = sorted(host)
    open_ops: List[Tuple[float, float, str]] = []
    labels, i = [], 0
    for t in points:
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(open_ops, (host[i][1], host[i][0], host[i][2]))
            i += 1
        while open_ops and open_ops[0][0] < t:
            heapq.heappop(open_ops)
        if not open_ops:
            labels.append("host: none")
            continue
        inner = sorted(open_ops, key=lambda op: op[0] - op[1])[:2]
        labels.append(" > ".join(op[2] for op in reversed(inner)))
    return labels


UPSAMPLE_OP = "aten::conv_transpose2d"
BACKWARD_NODE = "ConvolutionBackward0"


def _kernel_seconds(e) -> float:
    return sum(k.duration for k in e.kernels) * 1e-6 + sum(
        _kernel_seconds(c) for c in e.cpu_children)


def _subtree(e):
    yield e
    for c in e.cpu_children:
        yield from _subtree(c)


def upsample_seconds(events) -> float:
    """Device seconds of the kernels launched under the upsample's forward
    operators and under the backward nodes that share their sequence
    numbers."""
    forward = [e for e in events if e.name == UPSAMPLE_OP]
    seqs = {d.sequence_nr for e in forward for d in _subtree(e) if d.sequence_nr >= 0}
    backward = [e for e in events if e.name == BACKWARD_NODE and e.sequence_nr in seqs]
    return sum(_kernel_seconds(e) for e in forward + backward)


def _is_device(e) -> bool:
    """A kernel, copy or set: a CUDA row that is not a user annotation (a
    ``record_function`` range drawn on the device's timeline, which spans
    the gaps between its kernels)."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def busy_seconds(events) -> float:
    """The union of the device rows' intervals, in seconds."""
    busy = merge([(e.time_range.start * 1e-6, e.time_range.end * 1e-6)
                  for e in events if _is_device(e)])
    return sum(b - a for a, b in busy)


def reduce_profile(prof, wall_s: float) -> Dict:
    """``{"busy_s", "window_s", "upsample_s", "ops": {name: [seconds,
    count]}, "device_ops": [[name, s]...], "idle_gaps": [[label, s]...]}``
    of a finished profile over a stretch of ``wall_s`` seconds."""
    dev, host = [], []
    ops: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    events = prof.events()
    for e in events:
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if _is_device(e):
            dev.append((start, end))
            ops[e.name][0] += end - start
            ops[e.name][1] += 1
        elif end > start:
            host.append((start, end, e.name))
    busy = merge(dev)
    busy_s = sum(b - a for a, b in busy)
    gaps: Dict[str, float] = collections.defaultdict(float)
    spans = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    for (a, b), label in zip(spans, _host_labels(host, [0.5 * (a + b) for a, b in spans])):
        gaps[label] += b - a
    top_ops = sorted(ops.items(), key=lambda kv: kv[1][0], reverse=True)[:TOP]
    return {
        "busy_s": busy_s, "window_s": wall_s, "upsample_s": upsample_seconds(events),
        "ops": {k: v for k, v in ops.items()},
        "device_ops": [[name[:200], v[0]] for name, v in top_ops],
        "idle_gaps": sorted(([k[:200], v] for k, v in gaps.items()),
                            key=lambda kv: kv[1], reverse=True)[:TOP],
    }


def op_time(ops: Dict[str, List[float]], needle: str) -> Tuple[float, int]:
    """(seconds, count) of the device operations whose name holds ``needle``."""
    rows = [v for k, v in ops.items() if needle in k]
    return sum(r[0] for r in rows), int(sum(r[1] for r in rows))
