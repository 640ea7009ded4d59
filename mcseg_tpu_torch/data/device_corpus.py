"""Card-resident corpus: decode once, keep the corpus on the device, feed
each iteration by index.

The port of the JAX package's ``data/device_corpus.py`` on one device. The
corpus is decoded once and staged on the device in wire format (uint8 RGB,
uint16-mm depth, the target's labels dropped); each iteration's batch is
gathered there with ``index_select`` from a [B] index vector, so after
staging nothing but the indices crosses to the card.

The contract: ``corpus_stream`` draws its indices from the host pipeline's
``_index_batches`` (same seed, same burn-in for ``--resume``) and yields
exactly the tensors that ``device_prefetch(batch_iterator(...))`` yields,
so switching ``--device_corpus`` on or off cannot change a training result
(``tests/test_torch_host_train.py`` holds trained parameters bit-equal).
A rank of a data-parallel job stages the whole corpus and gathers its rows
of each global batch (``local_rows``), as the JAX package's replicated
corpus feeds each device its shard.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from mcseg_tpu_torch.data.datasets import ZipDataset
from mcseg_tpu_torch.data.pipeline import _index_batches, wire_format

Corpus = Dict[str, torch.Tensor]


def _per_sample_bytes(dataset, drop_label: bool) -> int:
    """Wire-format bytes of one decoded sample."""
    sample = wire_format(dataset[0], drop_label=drop_label)
    return sum(int(v.nbytes) for v in sample.values())


def corpus_fits(dataset, budget_gb: float) -> bool:
    """Would staging ``dataset`` (both sides of a ZipDataset) fit
    ``budget_gb`` of device memory?"""
    n = len(dataset)
    if isinstance(dataset, ZipDataset):
        per = (_per_sample_bytes(dataset.source, False)
               + _per_sample_bytes(dataset.target, True))
    else:
        per = _per_sample_bytes(dataset, False)
    return n * per <= budget_gb * 1e9


def resolve_device_corpus(cfg_data, dataset) -> bool:
    """``--device_corpus`` 'on' | 'off' | 'auto' (does the corpus fit
    ``device_corpus_gb``?) -> bool."""
    mode = getattr(cfg_data, "device_corpus", "auto")
    if isinstance(mode, bool):
        return mode
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"device_corpus must be 'auto'|'on'|'off' or bool, got {mode!r}")
    try:
        return corpus_fits(dataset, getattr(cfg_data, "device_corpus_gb", 4.0))
    except (OSError, ValueError):
        return False  # an unreadable sample: the host path reports it


def stage_corpus(dataset, device, drop_label: bool = False,
                 n: Optional[int] = None, chunk: int = 32) -> Corpus:
    """Decode ``dataset[:n]`` through its batch path, ``chunk`` samples at a
    time into preallocated [n, ...] host arrays, in wire format, and move
    it to ``device``."""
    n = len(dataset) if n is None else n
    out_np: Dict[str, np.ndarray] = {}
    for lo in range(0, n, chunk):
        idx = np.arange(lo, min(lo + chunk, n))
        b = wire_format(dataset.get_batch(idx), drop_label=drop_label)
        if not out_np:
            out_np = {k: np.empty((n,) + v.shape[1:], v.dtype) for k, v in b.items()}
        elif set(b) != set(out_np):
            # rows of a missing plane would stay uninitialized memory
            raise ValueError(
                f"corpus has inconsistent planes across samples: chunk at index {lo} "
                f"decoded {sorted(b)} but the corpus started with {sorted(out_np)} — "
                "every sample needs the same plane set (e.g. a partially populated "
                "depth/ directory)")
        for k, v in b.items():
            out_np[k][lo : lo + len(idx)] = v
    # the corpus now lives on the device: drop the host copy of the RAM cache
    if getattr(dataset, "_cache", None):
        dataset._cache.clear()
        dataset._cache_bytes = 0
    return {k: torch.from_numpy(v).to(device) for k, v in out_np.items()}


def corpus_stream(dataset, device, batch_size: int, shuffle: bool = True,
                  seed: int = 0, drop_last: bool = True, epochs: Optional[int] = None,
                  start_epoch: int = 0, local_rows: Optional[np.ndarray] = None
                  ) -> Iterator[Union[Corpus, Tuple[Corpus, Corpus]]]:
    """The card-resident replacement of
    ``device_prefetch(batch_iterator(...), device)``: the same batches
    (pairs for a ZipDataset), gathered on ``device``. The host builds one
    [B] index vector per iteration and the gather runs on the device's
    stream, so no prefetch thread is needed. ``local_rows`` keeps those
    rows of each global batch, as ``batch_iterator`` does."""
    device = torch.device(device)
    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    zipped = isinstance(dataset, ZipDataset)
    if zipped:
        src = stage_corpus(dataset.source, device, drop_label=False, n=n)
        tgt = stage_corpus(dataset.target, device, drop_label=True, n=n)
    else:
        src = stage_corpus(dataset, device, drop_label=False, n=n)

    def gather(corpus, idx):
        return {k: v.index_select(0, idx) for k, v in corpus.items()}

    for idx in _index_batches(n, batch_size, shuffle, seed, drop_last, epochs, start_epoch):
        if local_rows is not None:
            idx = idx[np.asarray(local_rows)]
        didx = torch.from_numpy(idx.astype(np.int64)).to(device)
        yield (gather(src, didx), gather(tgt, didx)) if zipped else gather(src, didx)
