"""Training-mode BatchNorm over the global batch of a data-parallel group.

In the JAX package, GSPMD computes every BatchNorm of a step sharded on
'data' over the global batch. ``sync_batch_norm`` does the same across the
ranks, in two implementations of one function:

  * on the card, torch's native SyncBatchNorm ops (the ones
    ``nn.SyncBatchNorm`` runs): ``batch_norm_stats`` per rank, one
    all-reduce of every rank's (mean, invstd, count), then
    ``batch_norm_gather_stats_with_counts`` (which also advances the
    running statistics) and ``batch_norm_elemt``; backward
    ``batch_norm_backward_reduce``, one all-reduce of (sum_dy, sum_dy_xmu),
    ``batch_norm_backward_elemt``. The per-rank statistics travel in an
    all-reduce of a [world, 2C+1] buffer each rank fills in its own row
    (an all-gather that gloo also runs on CUDA tensors);
  * ``sync_batch_norm_reference``, its plain twin: per-channel sums and
    sums of squared deviations from torch reductions, summed over the
    ranks by ``all_sum`` (autograd differentiates through it), on the CPU
    (the native ops have no CPU kernels) and as the card's reference.

Both advance the running variance with the unbiased global variance, as
torch does; ``models.drn.BatchNorm2d`` rescales it to flax's biased one.
Every rank must hold the same number of elements per channel.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from mcseg_tpu_torch.parallel.mesh import DataParallel, all_sum


class _NativeSyncBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, dp):
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous()
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = torch.full((1,), x.numel() // c, dtype=mean.dtype, device=mean.device)
        rows = torch.zeros(dp.world, 2 * c + 1, dtype=mean.dtype, device=mean.device)
        rows[dp.rank] = torch.cat([mean, invstd, count])
        dist.all_reduce(rows, group=dp.group)
        mean_all, invstd_all, count_all = torch.split(rows, c, dim=1)
        counts = count_all.reshape(-1)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, mean_all, invstd_all, running_mean, running_var, momentum, eps,
            counts.to(running_mean.dtype))
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        ctx.dp = dp
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, grad_out):
        if not grad_out.is_contiguous(memory_format=torch.channels_last):
            grad_out = grad_out.contiguous()
        x, weight, mean, invstd, counts = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            grad_out, x, mean, invstd, weight, need_x, need_w, need_b)
        grad_x = None
        if need_x:
            c = sum_dy.shape[0]
            both = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(both, group=ctx.dp.group)
            sum_dy, sum_dy_xmu = torch.split(both, c)
            grad_x = torch.batch_norm_backward_elemt(
                grad_out, x, mean, invstd, weight.to(mean.dtype), sum_dy, sum_dy_xmu, counts)
        return (grad_x, grad_w if need_w else None, grad_b if need_b else None,
                None, None, None, None, None)


def sync_batch_norm_native(x, weight, bias, running_mean, running_var, momentum: float,
                           eps: float, dp: DataParallel) -> torch.Tensor:
    """BatchNorm of ``x`` [B,C,H,W] (a CUDA tensor) over the group's global
    batch with torch's native SyncBatchNorm ops; advances the running
    statistics in place. Counts its calls in ``sync_batch_norm_native.calls``."""
    if x.device.type != "cuda":
        raise ValueError(f"the native SyncBatchNorm ops need a CUDA tensor, not {x.device}")
    sync_batch_norm_native.calls += 1
    return _NativeSyncBN.apply(x, weight, bias, running_mean, running_var, momentum, eps, dp)


sync_batch_norm_native.calls = 0


def sync_batch_norm_reference(x, weight, bias, running_mean, running_var, momentum: float,
                              eps: float, dp: DataParallel) -> torch.Tensor:
    """The plain twin of ``sync_batch_norm_native``: statistics in at
    least float32 from torch reductions summed over the ranks, the output
    in ``x``'s dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    dims = (0, 2, 3)
    n = xf.numel() // xf.shape[1] * dp.world
    mean = all_sum(xf.sum(dims), dp) / n
    centred = xf - mean[None, :, None, None]
    var = all_sum((centred * centred).sum(dims), dp) / n
    invstd = torch.rsqrt(var + eps)
    y = centred * (invstd * weight.to(dt))[None, :, None, None] + bias.to(dt)[None, :, None, None]
    with torch.no_grad():
        running_mean.mul_(1.0 - momentum).add_(momentum * mean.to(running_mean.dtype))
        running_var.mul_(1.0 - momentum).add_(
            momentum * var.to(running_var.dtype) * (n / max(n - 1, 1)))
    return y.to(x.dtype)


def sync_batch_norm(x, weight, bias, running_mean, running_var, momentum: float,
                    eps: float, dp: DataParallel) -> torch.Tensor:
    """Training-mode BatchNorm of ``x`` over the group's global batch: the
    native ops on a CUDA tensor, the plain twin on a CPU tensor."""
    fn = sync_batch_norm_native if x.device.type == "cuda" else sync_batch_norm_reference
    return fn(x, weight, bias, running_mean, running_var, momentum, eps, dp)
