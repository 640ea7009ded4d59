"""Host input pipeline: sample order, decode threads, wire format, prefetch
to the card.

The port of the JAX package's ``data/pipeline.py`` on one device:

* ``batch_iterator``: the seeded index stream (``_index_batches``, resume
  burn-in included) and stacked host batches through each reader's
  ``get_batch``; ``num_workers`` > 1 decodes ``prefetch_batches`` batches
  ahead on a thread pool, in the same order as the serial path. A rank of
  a data-parallel job draws the same global stream and decodes only its
  rows (``local_rows``).
* ``wire_format``: depth as uint16 millimetres, target labels dropped.
* ``device_prefetch``: a background thread turns host batches into wire
  format, pins them and copies them to the card on a side CUDA stream,
  ``depth`` batches ahead. The consumer's stream waits on each copy's
  event, and each tensor is recorded on the consumer's stream, so the
  caching allocator never hands out a buffer under a running copy. On the
  CPU the thread only converts.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np
import torch


def _index_batches(n, batch_size, shuffle, seed, drop_last, epochs, start_epoch=0):
    rng = np.random.RandomState(seed)
    # burn the skipped epochs' permutations so a resumed run sees exactly
    # the data stream an uninterrupted run would have seen from here on
    for _ in range(start_epoch if shuffle else 0):
        rng.permutation(n)
    epoch = start_epoch
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - batch_size + 1 if drop_last else n
        for i in range(0, stop, batch_size):
            yield order[i : i + batch_size]
        epoch += 1


def map_ahead(fn: Callable, items: Iterable, num_workers: int = 0,
              ahead: int = 2) -> Iterator:
    """``fn(item)`` for each item, in order. With ``num_workers`` > 1 the
    calls run on a thread pool, up to ``ahead`` + 1 of them in flight (file
    decode releases the GIL); the pool is shut down when the iterator ends
    or is closed."""
    if num_workers <= 1:
        for item in items:
            yield fn(item)
        return
    ex = ThreadPoolExecutor(num_workers, thread_name_prefix="mcseg-decode")
    try:
        pending: deque = deque()
        for item in items:
            pending.append(ex.submit(fn, item))
            if len(pending) > ahead:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: Optional[int] = None,
                   num_workers: int = 0, prefetch_batches: int = 2,
                   start_epoch: int = 0, local_rows: Optional[np.ndarray] = None
                   ) -> Iterator:
    """Yield stacked host batches (a pair of dicts for a ZipDataset).

    ``start_epoch`` fast-forwards the stream for a resumed run: it yields
    epochs [start_epoch, epochs) of the uninterrupted run. Each batch comes
    from the dataset's ``get_batch`` (whose native path also threads across
    the samples of the batch); ``num_workers`` > 1 keeps
    ``prefetch_batches`` further batches decoding on a thread pool.

    ``local_rows`` (a data-parallel rank's ``parallel.mesh.local_batch_rows``)
    decodes and yields only those rows of each global batch of
    ``batch_size``: every rank draws the same index stream, and decodes
    O(local batch) per step, as the JAX package's ``local_rows`` does."""
    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    idx_iter = _index_batches(n, batch_size, shuffle, seed, drop_last, epochs,
                              start_epoch)
    if local_rows is not None:
        if not drop_last:
            raise ValueError("local_rows needs drop_last: a short tail batch has no "
                             "rows of its own per rank")
        rows = np.asarray(local_rows)
        idx_iter = (idx[rows] for idx in idx_iter)
    yield from map_ahead(dataset.get_batch, idx_iter, num_workers, prefetch_batches)


def wire_format(batch: Dict[str, np.ndarray], drop_label: bool = False
                ) -> Dict[str, np.ndarray]:
    """Compact a host batch for the copy to the card: float32 depth in
    metres becomes uint16 millimetres (the corpus's storage precision;
    ``ops/preprocess.depth_to_meters`` reads it back), and ``drop_label``
    removes the labels of an unlabeled (target) batch, which MCD never
    reads."""
    out = {}
    for k, v in batch.items():
        if k == "label" and drop_label:
            continue
        if k == "depth" and v.dtype == np.float32:
            v = (np.clip(v, 0.0, 65.535) * 1000.0 + 0.5).astype(np.uint16)
        out[k] = v
    return out


def wire_items(item):
    """``wire_format`` of a host batch, or of a (source, target) pair with
    the target's labels dropped."""
    if isinstance(item, tuple):
        return tuple(wire_format(b, drop_label=(i == 1)) for i, b in enumerate(item))
    return wire_format(item)


def device_prefetch(host_iter: Iterator, device, depth: int = 2) -> Iterator:
    """Overlap host decode and the copy to the card with the card's work.

    A daemon thread takes each host batch (or pair), applies
    ``wire_format`` (``wire_items``), and on a CUDA device pins it and
    copies it with ``non_blocking=True`` on a side stream, then queues the
    tensors with the copy's event; at most ``depth`` batches wait in the
    queue. The consumer makes its current stream wait on the event and
    records each tensor on that stream before yielding it. An error of the
    thread is raised to the consumer; a consumer that stops early stops the
    thread and closes ``host_iter``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list = []
    closed = threading.Event()

    def put(x) -> bool:
        # a bounded put that notices an abandoned consumer
        while not closed.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        if not cuda:
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                .to(device, non_blocking=True) for k, v in batch.items()}

    def worker():
        try:
            with torch.cuda.device(device) if cuda else contextlib.nullcontext(), \
                    torch.cuda.stream(side) if cuda else contextlib.nullcontext():
                for item in host_iter:
                    item = wire_items(item)
                    if isinstance(item, tuple):
                        out = tuple(to_device(b) for b in item)
                    else:
                        out = to_device(item)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(side)
                    if not put((out, event)):
                        return
        except Exception as e:  # raised again on the consumer's thread
            err.append(e)
        finally:
            close = getattr(host_iter, "close", None)
            if close is not None:
                close()
            put(sentinel)

    thread = threading.Thread(target=worker, name="mcseg-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is sentinel:
                if err:
                    raise err[0]
                return
            out, event = got
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for batch in (out if isinstance(out, tuple) else (out,)):
                    for t in batch.values():
                        t.record_stream(stream)
            yield out
    finally:
        closed.set()

