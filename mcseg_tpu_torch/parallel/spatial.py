"""Spatial partitioning of training: activation rows split over ranks.

The port of the JAX package's 2-D mesh (``parallel/mesh.py make_mesh(
spatial=s)``, ``constrain_spatial``; ``train/loops.py _spatial``). There,
``Mesh((n/s, s), ('data', 'space'))`` shards every preprocessed train
input with the batch on 'data' and the height on 'space', and GSPMD
shards every activation's height, inserting the conv halo exchanges, the
cross-shard BatchNorm and loss reductions and the gradient all-reduce. Here
rank r of n holds data block r // s of the global batch and row block
r % s of every activation (``parallel.mesh.DataParallel``), and the
exchanges are explicit:

  * ``spatial_layout``: the sub-groups of a layout, built on every rank in
    one order: the s ranks of each data block (``space_group``, the halo
    exchanges) and the n/s ranks of each row block (``data_group``).
  * ``halo_rows``: a row block with ``above`` and ``below`` rows of its
    neighbours, zeros (or the edge row repeated) beyond the image's global
    top and bottom; an autograd function whose backward sends the halo
    rows' gradients back to the ranks that own them and adds them there.
    A halo may be taller than a neighbour's block (DRN's dilation 4 on a
    one-row block): the rows come from as many ranks as they span. Every
    rank's top and bottom ``min(halo, rows)`` rows travel in one
    all-reduce of a [s, 2, ...] buffer, each rank filling its own slot (an
    all-gather that gloo also runs on CUDA tensors, for ranks sharing a
    card), and the backward is the same all-reduce of the gradients.
  * ``RowSplit``: the modules that act on row blocks in training
    (``models/drn.py Conv2d``, which every trunk's convs are, the heads'
    upsamples, FCN8s's decoder, PSPNet's stem pool and pyramid pooling),
    given the layout by ``models.drn.set_data_parallel``.
  * ``across_space``: the ranks of this rank's data block, for sums over
    the whole image's rows (PSPNet's pyramid bins, ``mesh.all_sum``).
  * ``shard_rows``: this rank's rows of whole preprocessed images.
  * ``check_spatial``: the layouts the JAX package refuses: a height the
    row blocks do not divide at every level of the trunk (``trunk_stride``).

BatchNorm, the losses and the gradients need nothing more: they reduce
over all n ranks (``parallel/mesh.py``), each holding a disjoint share.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from mcseg_tpu_torch.parallel.mesh import DataParallel

TRUNK_STRIDE = 8  # DRN's and PSPNet's deepest level: every level halves H up to 8x
FCN_STRIDE = 32  # FCN8s: five 2x2 pools halve H up to 32x
FCN_NETS = ("fcn", "fcn8s", "fcn8s_vgg16")


def trunk_stride(net: str) -> int:
    """How far the trunk ``net`` halves the height: 32 for FCN8s (its five
    pools), 8 for DRN and PSPNet."""
    return FCN_STRIDE if net in FCN_NETS else TRUNK_STRIDE


def check_spatial(net: str, img_h: int, space: int) -> None:
    """Refuse a height ``img_h`` that ``space`` row blocks do not divide at
    every level of the trunk ``net`` (``ValueError``, JAX's stated
    precondition): each level's blocks must start on an even row, for the
    stride-2 convs and FCN8s's 2x2 pools to stay within a block."""
    if space <= 1:
        return
    stride = trunk_stride(net)
    if img_h % (stride * space):
        levels = ", ".join(["H"] + [f"H/{2 ** i}" for i in range(1, stride.bit_length())])
        raise ValueError(
            f"--spatial_devices {space}: the train height {img_h} is not divisible by "
            f"{space} at every level of --net {net} ({levels} each split in {space} "
            f"blocks of an even start row): H must be a multiple of {stride * space} "
            f"({stride}x{space})")


def check_ranks(space: int, world: int) -> None:
    """``space`` must divide the ``world`` ranks (``ValueError``)."""
    if space < 1 or world % space:
        raise ValueError(f"--spatial_devices {space} does not divide the {world} "
                         "rank(s) of the job")


def spatial_layout(dp: DataParallel, space: int) -> DataParallel:
    """``dp`` laid out as (n/space) data blocks x ``space`` row blocks, its
    sub-groups built (every rank of the job must call this, in the same
    order); ``dp`` itself when ``space`` is 1."""
    check_ranks(space, dp.world)
    if space == 1:
        return DataParallel(rank=dp.rank, world=dp.world, device=dp.device, group=dp.group)
    blocks = dp.world // space
    space_groups = [dist.new_group(list(range(b * space, (b + 1) * space)))
                    for b in range(blocks)]
    data_groups = [dist.new_group(list(range(j, dp.world, space))) for j in range(space)]
    return DataParallel(rank=dp.rank, world=dp.world, device=dp.device, group=dp.group,
                        space=space, space_group=space_groups[dp.rank // space],
                        data_group=data_groups[dp.rank % space])


def across_data(dp: Optional[DataParallel]) -> Optional[DataParallel]:
    """The group that holds every data block once: ``dp`` without spatial
    partitioning, else this rank's ``data_group`` (the ranks of its row
    block), for work on whole images such as scoring."""
    if dp is None or dp.space == 1:
        return dp
    return DataParallel(rank=dp.data_rank, world=dp.data_blocks, device=dp.device,
                        group=dp.data_group)


def across_space(dp: DataParallel) -> DataParallel:
    """The ``space`` ranks of this rank's data block (its ``space_group``),
    as a group of their own: ``mesh.all_sum`` over it sums a quantity over
    the row blocks of the block's images, and its backward sums the
    gradients back over them."""
    return DataParallel(rank=dp.space_rank, world=dp.space, device=dp.device,
                        group=dp.space_group)


def shard_rows(dp: Optional[DataParallel], *planes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """This rank's row block of each of ``planes`` ([B, H, ...]: NHWC
    images, label and depth planes), contiguous; the planes themselves
    without spatial partitioning."""
    if dp is None or dp.space == 1:
        return planes
    out = []
    for p in planes:
        rows = p.shape[1] // dp.space
        out.append(p.narrow(1, dp.space_rank * rows, rows).contiguous())
    return tuple(out)


def _halo_index(dp: DataParallel, rows: int, block: int, above: int, below: int,
                replicate: bool) -> torch.Tensor:
    """For each halo row (``above`` then ``below``), its place in the
    flattened [space, 2, block] exchange buffer (slot 0: a rank's top
    ``block`` rows, 1: its bottom ones), or ``space * 2 * block`` (a zero
    row) beyond the image; ``replicate`` maps those to the edge row."""
    s, k = dp.space, dp.space_rank
    height, zero = rows * s, s * 2 * block
    wanted = list(range(k * rows - above, k * rows)) + \
        list(range((k + 1) * rows, (k + 1) * rows + below))
    index: List[int] = []
    for g in wanted:
        if replicate:
            g = min(max(g, 0), height - 1)
        if not 0 <= g < height:
            index.append(zero)
            continue
        owner, off = divmod(g, rows)
        slot = (0, off) if off < block else (1, off - (rows - block))
        index.append((owner * 2 + slot[0]) * block + slot[1])
    return torch.tensor(index, dtype=torch.long)


def _exchange(x: torch.Tensor, dp: DataParallel, block: int) -> torch.Tensor:
    """Every rank's top and bottom ``block`` rows of ``x`` [B, C, rows, W],
    as a flat [space * 2 * block + 1, B, C, W] buffer with a zero row last."""
    s, k = dp.space, dp.space_rank
    rows = x.shape[2]
    buf = x.new_zeros((s * 2 * block + 1,) + (x.shape[0], x.shape[1], x.shape[3]))
    mine = buf[:-1].view(s, 2, block, x.shape[0], x.shape[1], x.shape[3])
    mine[k, 0] = x[:, :, :block].permute(2, 0, 1, 3)
    mine[k, 1] = x[:, :, rows - block:].permute(2, 0, 1, 3)
    dist.all_reduce(buf[:-1], group=dp.space_group)
    return buf


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp, above, below, replicate):
        rows = x.shape[2]
        block = min(max(above, below), rows)
        index = _halo_index(dp, rows, block, above, below, replicate).to(x.device)
        halo = _exchange(x, dp, block).index_select(0, index).permute(1, 2, 0, 3)
        ctx.dp, ctx.shape, ctx.block, ctx.index = dp, x.shape, block, index
        ctx.above = above
        return torch.cat([halo[:, :, :above], x, halo[:, :, above:]], dim=2)

    @staticmethod
    def backward(ctx, grad):
        dp, block, above = ctx.dp, ctx.block, ctx.above
        b, c, rows, w = ctx.shape
        s, k = dp.space, dp.space_rank
        grad_x = grad[:, :, above:above + rows].clone()
        halo = torch.cat([grad[:, :, :above], grad[:, :, above + rows:]], dim=2)
        buf = grad.new_zeros((s * 2 * block + 1, b, c, w))
        buf.index_add_(0, ctx.index, halo.permute(2, 0, 1, 3))
        dist.all_reduce(buf[:-1], group=dp.space_group)
        sent = buf[:-1].view(s, 2, block, b, c, w)
        grad_x[:, :, :block] += sent[k, 0].permute(1, 2, 0, 3)
        grad_x[:, :, rows - block:] += sent[k, 1].permute(1, 2, 0, 3)
        return grad_x, None, None, None, None


def halo_rows(x: torch.Tensor, dp: DataParallel, above: int, below: int,
              replicate: bool = False) -> torch.Tensor:
    """``x`` [B, C, rows, W], this rank's row block of a [B, C, rows * space,
    W] map, with ``above`` rows before it and ``below`` after it from the
    ranks of its data block: [B, C, above + rows + below, W]. Beyond the
    image's global top and bottom the halo is zeros, or with ``replicate``
    the edge row. Differentiable: the halo's gradients go back to the
    ranks that own its rows."""
    if above == 0 and below == 0:
        return x
    return _Halo.apply(x, dp, above, below, replicate)


class RowSplit:
    """A module that acts on row blocks in training under ``spatial`` (a
    ``DataParallel`` with ``space`` > 1; None: on whole images)."""

    spatial: Optional[DataParallel] = None

    def row_split(self) -> Optional[DataParallel]:
        """The layout of a training-mode forward, or None."""
        return self.spatial if getattr(self, "training", False) else None
