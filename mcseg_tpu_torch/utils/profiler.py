"""Profiling hooks: a trace context manager and a step timer.

The port of the JAX package's ``utils/profiler.py``. ``trace`` records a
``torch.profiler`` trace (host operators and, on the card, its kernels and
copies) and writes it as a Chrome/Perfetto trace file; ``time_step`` times
a step with its warm-up excluded and returns the rate, the BASELINE
metric.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Iterator

import torch
from torch.profiler import ProfilerActivity, profile

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
