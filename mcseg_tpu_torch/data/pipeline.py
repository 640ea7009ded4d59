"""Host batch stream: the seeded sample order, decode and stack.

The synchronous half of the JAX package's ``data/pipeline.py``: the same
index stream for the same seed (``_index_batches``, resume burn-in
included), and batches of raw numpy planes. Decode threads and a
card-resident corpus come in a later slice.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from mcseg_tpu_torch.data.datasets import ZipDataset, stack_samples


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


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: Optional[int] = None,
                   start_epoch: int = 0) -> Iterator:
    """Yield stacked host batches (a pair of dicts for ZipDataset items).

    ``start_epoch`` fast-forwards the stream for a resumed run: it yields
    epochs [start_epoch, epochs) of the uninterrupted run."""
    n = len(dataset)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    for idx in _index_batches(n, batch_size, shuffle, seed, drop_last, epochs,
                              start_epoch):
        if isinstance(dataset, ZipDataset):
            yield (stack_samples(dataset.source, idx),
                   stack_samples(dataset.target, idx))
        else:
            yield stack_samples(dataset, idx)
