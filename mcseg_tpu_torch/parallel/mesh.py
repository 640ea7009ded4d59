"""The data-parallel context and the collectives the training path needs.

The port of the data-parallel part of the JAX package's
``parallel/mesh.py``. There, one jitted step sees the global batch sharded
on the 'data' axis and GSPMD reduces BatchNorm statistics, every loss and
every gradient over it. Here each process holds one card, its block of the
global batch and a replica of the state, and the reductions are explicit:

  * ``DataParallel``: the process group, this rank, the world size and the
    card, and the extent ``space`` of spatial partitioning with its
    sub-groups (``parallel/spatial.py``). Every helper takes ``dp=None`` to
    mean a single process, and is then the identity, so the default path
    is the plain one.
  * ``local_batch_rows``: data block b holds the contiguous block b of a
    global batch, as ``P('data')`` places rows; a batch the data blocks do
    not divide is refused, as JAX's sharding refuses it.

Two counts stay apart. The ranks lay out as JAX's ``Mesh((n/s, s),
('data', 'space'))``: rank r holds data block r // s of the global batch
and row block r % s of every activation. The *data blocks* (n/s) divide
the batch: the input stream, the crop and flip draws and the batch checks
count them (``data_blocks``, ``batch_rows``). The *ranks* (n) each hold a
disjoint share of every activation: BatchNorm's element count, the losses'
means and the gradient average count them (``world_size``, ``dp.world``).
  * ``all_sum`` / ``all_max``: reductions over the ranks that autograd
    differentiates. Each rank's loss is the global loss; the backward of a
    reduction sums the upstream gradients over the ranks (the semantics of
    ``torch.distributed.nn``), so the gradient each rank then holds is the
    world size times its share, and ``all_reduce_grads`` averages them: the
    sum of the shares is the gradient of the global loss, whatever the
    reduction (a mean over unevenly ignored pixels, berHu's max).
  * ``all_reduce_grads`` / ``broadcast_tensors``: bucketed collectives over
    ``.grad`` before an optimizer step, and over a state at the start.

Every rank must hold a batch of the same shape: the loops guarantee it
(``local_batch_rows``), and the losses' element counts rely on it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

_BUCKET_BYTES = 32 * 2**20


@dataclass(frozen=True)
class DataParallel:
    """One process of a data-parallel job: ``rank`` of ``world`` on
    ``device``, over ``group`` (None: the default process group). Under
    spatial partitioning (``space`` > 1) the rank holds row block
    ``space_rank`` of data block ``data_rank``; ``space_group`` joins the
    ``space`` ranks of its data block (the halo exchanges), ``data_group``
    the ranks that hold its row block of every data block."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    space: int = 1
    space_group: Optional[object] = None
    data_group: Optional[object] = None

    @property
    def data_blocks(self) -> int:
        return self.world // self.space

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space


def local_batch_rows(blocks: int, block: int, global_batch: int,
                     what: str = "ranks") -> np.ndarray:
    """Rows of a [global_batch, ...] batch that data block ``block`` holds:
    the contiguous block ``block`` of ``blocks`` equal blocks, int64
    (``what`` the blocks are, for the refusal of a batch they do not
    divide)."""
    if global_batch % blocks:
        raise ValueError(f"batch {global_batch} is not divisible by the {blocks} {what} "
                         "of the data-parallel group")
    per = global_batch // blocks
    return np.arange(block * per, (block + 1) * per, dtype=np.int64)


def batch_rows(dp: Optional[DataParallel], global_batch: int) -> Optional[np.ndarray]:
    """``local_batch_rows`` of this rank's data block, or None (every row)
    without a group."""
    if dp is None:
        return None
    return local_batch_rows(dp.data_blocks, dp.data_rank, global_batch,
                            "data blocks" if dp.space > 1 else "ranks")


def world_size(dp: Optional[DataParallel]) -> int:
    """The ranks holding disjoint shares of every activation (1 without a
    group)."""
    return 1 if dp is None else dp.world


def data_blocks(dp: Optional[DataParallel]) -> int:
    """The data blocks the global batch splits into (1 without a group)."""
    return 1 if dp is None else dp.data_blocks


def _all_reduce(x: torch.Tensor, dp: DataParallel, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=dp.group)
    return y


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return _all_reduce(x, dp)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.dp), None


class _AllMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        y = _all_reduce(x, dp, dist.ReduceOp.MAX)
        held = (x == y).to(x.dtype)
        ctx.dp, ctx.share = dp, held / _all_reduce(held, dp)  # ties split evenly
        return y

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.dp) * ctx.share, None


def all_sum(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; its backward sums the
    upstream gradients over the ranks. ``x`` itself without a group."""
    return x if dp is None else _AllSum.apply(x, dp)


def all_max(x: torch.Tensor, dp: Optional[DataParallel]) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks, on every rank; its
    backward sends the upstream gradients, summed over the ranks, to the
    rank(s) holding the max. ``x`` itself without a group."""
    return x if dp is None else _AllMax.apply(x, dp)


def _bucketed(tensors: Iterable[torch.Tensor], device: torch.device,
              collective: Callable[[torch.Tensor], None]) -> None:
    """Apply ``collective`` in place to flat buckets of ``tensors`` (grouped
    by dtype and device, up to 32 MiB each) on ``device``, and copy the
    results back: a few large collectives instead of one per tensor, flat
    buffers whatever the tensors' memory format, and a tensor kept on the
    host (an optimizer's step count) carried on the group's device."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for group in buckets.values():
        start = 0
        while start < len(group):
            end, nbytes = start, 0
            while end < len(group) and (end == start or nbytes + group[end].numel()
                                        * group[end].element_size() <= _BUCKET_BYTES):
                nbytes += group[end].numel() * group[end].element_size()
                end += 1
            chunk = group[start:end]
            flat = torch.cat([t.reshape(-1) for t in chunk]).to(device)
            collective(flat)
            offset = 0
            for t in chunk:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            start = end


def all_reduce_grads(dp: Optional[DataParallel], *optimizers: torch.optim.Optimizer) -> None:
    """Average the ``.grad`` of every parameter of ``optimizers`` over the
    ranks (a parameter without a gradient must have none on every rank);
    a no-op without a group."""
    if dp is None:
        return
    grads = [p.grad for opt in optimizers for group in opt.param_groups
             for p in group["params"] if p.grad is not None]

    def average(flat):
        dist.all_reduce(flat, group=dp.group)
        flat.div_(dp.world)

    _bucketed(grads, dp.device, average)


def broadcast_tensors(dp: Optional[DataParallel], tensors: List[torch.Tensor],
                      src: int = 0) -> None:
    """Overwrite ``tensors`` on every rank with rank ``src``'s values; a
    no-op without a group."""
    if dp is None:
        return
    _bucketed(tensors, dp.device, lambda flat: dist.broadcast(flat, src=src, group=dp.group))
