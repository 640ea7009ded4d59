"""Multitask train steps: segmentation plus an auxiliary depth head and an
optional boundary head, source-only or with MCD, eager PyTorch.

The port of the JAX package's ``train/multitask.py``
(``make_multitask_source_step``, ``make_multitask_mcd_step``). G is shared
by the classifiers and the auxiliary heads of the state (``state.d``, and
``state.b`` when the run trains a boundary head); on a source batch

    loss = CE(F1) + CE(F2) + w_d * berHu(D, depth)  [+ w_b * balancedBCE(B)]

with the boundary targets derived from the source labels. The MCD variant
puts this loss in step A, which updates G, F1, F2, D and B; steps B and C
are the plain discrepancy game of ``train/mcd.py``. In step B the
auxiliary heads get zero gradients, so opt_f still applies weight decay and
momentum to them, as optax does to its whole tree. As in the JAX trainer,
the multitask MCD step has no ``uses_one_classifier`` variant. Both steps
reseed the dropout masks as the other trainers do, though the one trunk
with dropout, FCN8s, has no multitask heads (``models.factory.get_aux_heads``).
Under a data-parallel context every loss is the global batch's and the
gradients are averaged over the ranks before each update (``train/mcd.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mcseg_tpu_torch.core.config import TrainConfig
from mcseg_tpu_torch.core.device import compute_context
from mcseg_tpu_torch.losses.discrepancy import get_prob_distance_criterion
from mcseg_tpu_torch.losses.seg import (
    balanced_bce_2d, berhu_loss, boundary_targets_from_labels, cross_entropy_2d)
from mcseg_tpu_torch.parallel.mesh import DataParallel, all_reduce_grads
from mcseg_tpu_torch.train.mcd import step_b, step_c
from mcseg_tpu_torch.train.optim import make_lr_schedule, set_lr
from mcseg_tpu_torch.train.state import MCDTrainState
from mcseg_tpu_torch.utils.profiler import span


def aux_head_keys(boundary_weight: float) -> Tuple[str, ...]:
    """The auxiliary heads a run trains: "D", and "B" when the boundary
    loss has a positive weight."""
    return ("D", "B") if boundary_weight > 0 else ("D",)


def _source_losses(state: MCDTrainState, x, y, depth, depth_weight: float,
                   boundary_weight: float, dtype: torch.dtype,
                   dp: Optional[DataParallel] = None, boundary=None):
    """(total, seg, depth, boundary or None) of one source batch, G and
    every head applied once in train mode. ``boundary``: the (targets,
    valid) of the boundary loss when the caller derived them (from whole
    labels, under spatial partitioning); else they come from ``y``."""
    with compute_context(dtype, x.device):
        feat = state.g(x)
        o1, o2 = state.f1(feat), state.f2(feat)
        d_pred = state.d(feat)
        b_logits = state.b(feat) if state.b is not None else None
    seg = cross_entropy_2d(o1, y, dp=dp) + cross_entropy_2d(o2, y, dp=dp)
    dep = berhu_loss(d_pred, depth, dp=dp)
    aux = depth_weight * dep
    bnd = None
    if b_logits is not None:
        targets = boundary if boundary is not None else boundary_targets_from_labels(y)
        bnd = balanced_bce_2d(b_logits, *targets, dp=dp)
        aux = aux + boundary_weight * bnd
    return seg + aux, seg, dep, bnd


def _update_all(state: MCDTrainState, loss: torch.Tensor,
                dp: Optional[DataParallel] = None) -> None:
    state.opt_g.zero_grad(set_to_none=True)
    state.opt_f.zero_grad(set_to_none=True)
    loss.backward()
    all_reduce_grads(dp, state.opt_g, state.opt_f)
    state.opt_g.step()
    state.opt_f.step()


def make_multitask_source_step(cfg: TrainConfig, depth_weight: float = 0.5,
                               boundary_weight: float = 0.0,
                               dtype: torch.dtype = torch.float32,
                               dp: Optional[DataParallel] = None) -> Callable:
    """``step(state, x, y, depth, boundary=None) -> metrics``: ``x`` the
    preprocessed input NCHW, ``y`` the labels [B,H,W], ``depth`` metres
    [B,H,W] (pixels not finite or <= 0 unsupervised), ``boundary`` the
    boundary head's (targets, valid) when derived by the caller. Updates
    ``state`` in place; metrics ``loss``, ``loss_seg``, ``loss_depth``,
    ``lr`` and ``loss_boundary`` when the state has a boundary head (losses
    detached on the device). ``dp``: the data-parallel context, as in
    ``train.mcd.make_mcd_step``."""
    lr_fn = make_lr_schedule(cfg.lr_schedule, cfg.lr, cfg.max_steps, cfg.lr_power)

    def step(state: MCDTrainState, x, y, depth, boundary=None) -> Dict[str, object]:
        lr = lr_fn(state.step)
        set_lr(state.opt_g, lr)
        set_lr(state.opt_f, lr)
        state.reseed_masks()
        loss, seg, dep, bnd = _source_losses(state, x, y, depth, depth_weight,
                                             boundary_weight, dtype, dp, boundary)
        _update_all(state, loss, dp)
        state.step += 1
        metrics = {"loss": loss.detach(), "loss_seg": seg.detach(),
                   "loss_depth": dep.detach(), "lr": lr}
        if bnd is not None:
            metrics["loss_boundary"] = bnd.detach()
        return metrics

    return step


def make_multitask_mcd_step(cfg: TrainConfig, depth_weight: float = 0.5,
                            boundary_weight: float = 0.0,
                            dtype: torch.dtype = torch.float32,
                            dp: Optional[DataParallel] = None) -> Callable:
    """``step(state, xs, ys, ds, xt, mark=None) -> metrics``: MCD A / B /
    C x num_k with the auxiliary losses in step A (``ds`` the source depth
    in metres [B,H,W]). Metrics ``loss_source`` (the whole step-A loss),
    ``loss_seg``, ``loss_depth``, ``loss_b``, ``loss_dis``, ``lr`` and
    ``loss_boundary`` when the state has a boundary head. ``mark(name)``,
    when given, is called after each sub-step ('A', 'B', 'C'); ``boundary``
    as in ``make_multitask_source_step``. ``dp``: the data-parallel
    context."""
    disc = get_prob_distance_criterion(cfg.d_loss, dp)
    lr_fn = make_lr_schedule(cfg.lr_schedule, cfg.lr, cfg.max_steps, cfg.lr_power)

    def step(state: MCDTrainState, xs, ys, ds, xt,
             mark: Optional[Callable[[str], None]] = None,
             boundary=None) -> Dict[str, object]:
        lr = lr_fn(state.step)
        with span("mcd.step_a"):
            set_lr(state.opt_g, lr)
            set_lr(state.opt_f, lr)
            state.reseed_masks()
            loss_a, seg, dep, bnd = _source_losses(state, xs, ys, ds, depth_weight,
                                                   boundary_weight, dtype, dp, boundary)
            _update_all(state, loss_a, dp)
        if mark:
            mark("A")
        with span("mcd.step_b"):
            loss_b = step_b(state, state.f2, xs, ys, xt, disc, dtype, dp)
        if mark:
            mark("B")
        with span("mcd.step_c"):
            loss_c = step_c(state, state.f2, xt, disc, dtype, cfg.num_k, dp)
        if mark:
            mark("C")
        state.step += 1
        metrics = {"loss_source": loss_a.detach(), "loss_seg": seg.detach(),
                   "loss_depth": dep.detach(), "loss_b": loss_b, "loss_dis": loss_c,
                   "lr": lr}
        if bnd is not None:
            metrics["loss_boundary"] = bnd.detach()
        return metrics

    return step
