"""Structured training logs and a throughput meter.

The port of the JAX package's ``utils/logging.py``: a JSONL step log plus
stdout lines, optionally a TensorBoard event stream, and a StepTimer whose
rate leaves out the first (warm-up) steps.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from mcseg_tpu_torch.parallel.multihost import is_primary


def make_run_logger(train_cfg) -> "JsonlLogger":
    """The run directory's log: ``<out_dir>/train_log.jsonl``, plus
    TensorBoard scalars under ``train_cfg.tb_dir`` when it is set. On a
    rank other than 0 of a data-parallel job (whose metrics are rank 0's)
    a silent logger that writes nothing."""
    if not is_primary():
        return JsonlLogger(path=None, echo=False)
    return JsonlLogger(path=os.path.join(train_cfg.out_dir, "train_log.jsonl"),
                       tb_dir=train_cfg.tb_dir or None)


class JsonlLogger:
    """One JSON object per record, appended to ``path``, echoed to stdout.

    ``tb_dir`` also writes every float of a record as a TensorBoard scalar
    at the record's "step" (``torch.utils.tensorboard``, imported only
    then); without the ``tensorboard`` package it warns and goes on."""

    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tb_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print(f"warning: --tb_dir {tb_dir!r} ignored (no tensorboard)")
            else:
                self._tb = SummaryWriter(tb_dir)

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (v.item() if hasattr(v, "item") else v) for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self._tb is not None:
            step = int(record.get("step", 0))
            for k, v in record.items():
                if isinstance(v, float) and k != "step":
                    self._tb.add_scalar(k, v, global_step=step)
            self._tb.flush()
        if self.echo:
            parts = [f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in record.items()]
            print("  ".join(parts), flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


class StepTimer:
    """Items per second over the steps after the first ``skip_first``."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.n_steps = 0
        self.n_items = 0
        self._t0 = None

    def tick(self, items: int) -> None:
        self.n_steps += 1
        if self.n_steps == self.skip_first:
            self._t0 = time.perf_counter()
        elif self.n_steps > self.skip_first:
            self.n_items += items

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self.n_items == 0:
            return 0.0
        return self.n_items / (time.perf_counter() - self._t0)
