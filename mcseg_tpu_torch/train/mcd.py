"""MCD adaptation iteration, eager PyTorch.

The port of the JAX package's ``train/mcd.py`` ``make_mcd_step`` (Saito et
al., CVPR 2018, Maximum Classifier Discrepancy):

  STEP A  minimize CE(F1(G(xs)), ys) + CE(F2(G(xs)), ys)      wrt G, F1, F2
  STEP B  minimize CE terms  -  d(F1(G(xt)), F2(G(xt)))        wrt F1, F2 only
  STEP C  minimize d(F1(G(xt)), F2(G(xt)))                     wrt G only,
          num_k times, each with a fresh forward

G stays in train mode throughout, so its BatchNorm statistics advance in
every forward, in the order A: xs; B: xs, xt; C: xt x num_k, and a G with
dropout draws fresh masks in every forward, in the same order (a new mask
for each of step C's repetitions, as the JAX step's ``fold_in(kc, i)``),
from the state's mask source reseeded per iteration. In step B G
runs under ``no_grad``; in step C only G's gradients are taken
(``torch.autograd.grad``), so neither head nor opt_f's momentum moves.

``uses_one_classifier`` applies F1 in F2's place. Every parameter opt_f
covers that a step gives no gradient (F2 then, and the multitask trainer's
auxiliary heads in step B) gets a zero gradient rather than none, so that
its optimizer still applies weight decay (and momentum) to it, as optax
does to its whole tree in the JAX step. Steps B and C are shared with the
multitask trainer (``train/multitask.py``).

Under a data-parallel context ``dp`` (``parallel.mesh``) every loss is the
loss of the group's global batch, G's BatchNorm statistics are global, and
the gradients are averaged over the ranks (``all_reduce_grads``) before
every optimizer step: A over opt_g and opt_f, B over opt_f, C over opt_g
(each of the ``num_k`` times). The modules are not wrapped in
``DistributedDataParallel``, whose hooks assume one backward per forward:
step B runs G under ``no_grad`` and step C takes G's gradients alone.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from mcseg_tpu_torch.core.config import TrainConfig
from mcseg_tpu_torch.core.device import compute_context
from mcseg_tpu_torch.losses.discrepancy import get_prob_distance_criterion
from mcseg_tpu_torch.losses.seg import cross_entropy_2d
from mcseg_tpu_torch.parallel.mesh import DataParallel, all_reduce_grads
from mcseg_tpu_torch.train.optim import make_lr_schedule, set_lr
from mcseg_tpu_torch.train.state import MCDTrainState
from mcseg_tpu_torch.utils.profiler import span


def zero_missing_grads(opt: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter of ``opt`` that has none."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def step_b(state: MCDTrainState, f2: nn.Module, xs: torch.Tensor, ys: torch.Tensor,
           xt: torch.Tensor, disc: Callable, dtype: torch.dtype,
           dp: Optional[DataParallel] = None) -> torch.Tensor:
    """STEP B: maximize the discrepancy on the target wrt opt_f's heads
    while keeping the source supervised; G runs in train mode under
    ``no_grad``. ``disc`` must reduce over ``dp``'s global batch. Returns
    the loss, detached."""
    f1 = state.f1
    state.opt_f.zero_grad(set_to_none=True)
    with compute_context(dtype, xs.device):
        with torch.no_grad():
            feat_s = state.g(xs)
            feat_t = state.g(xt)
        o1s, o2s = f1(feat_s), f2(feat_s)
        o1t, o2t = f1(feat_t), f2(feat_t)
    loss_b = (cross_entropy_2d(o1s, ys, dp=dp) + cross_entropy_2d(o2s, ys, dp=dp)
              - disc(o1t, o2t))
    loss_b.backward()
    zero_missing_grads(state.opt_f)
    all_reduce_grads(dp, state.opt_f)
    state.opt_f.step()
    return loss_b.detach()


def step_c(state: MCDTrainState, f2: nn.Module, xt: torch.Tensor, disc: Callable,
           dtype: torch.dtype, num_k: int, dp: Optional[DataParallel] = None) -> torch.Tensor:
    """STEP C: minimize the discrepancy wrt G only, ``num_k`` times, each
    with a fresh forward (``disc`` over ``dp``'s global batch). Returns the
    last loss, detached."""
    g, f1 = state.g, state.f1
    g_params = [p for p in g.parameters() if p.requires_grad]
    for _ in range(num_k):
        with compute_context(dtype, xt.device):
            feat_t = g(xt)
            o1t, o2t = f1(feat_t), f2(feat_t)
        loss_c = disc(o1t, o2t)
        grads = torch.autograd.grad(loss_c, g_params)
        for p, grad in zip(g_params, grads):
            p.grad = grad
        all_reduce_grads(dp, state.opt_g)
        state.opt_g.step()
        del feat_t, o1t, o2t, grads
    return loss_c.detach()


def make_mcd_step(cfg: TrainConfig, uses_one_classifier: bool = False,
                  dtype: torch.dtype = torch.float32,
                  dp: Optional[DataParallel] = None) -> Callable:
    """``step(state, xs, ys, xt, mark=None) -> metrics``.

    ``xs``/``xt`` are the preprocessed source and target inputs, NCHW
    (channels_last memory; float64 under a float64 oracle), ``ys`` the
    source labels [B,H,W]. The step updates ``state`` in place and returns
    ``{'loss_source', 'loss_b', 'loss_dis', 'lr'}``: the losses as detached
    scalar tensors on the device (read them only where the host needs
    them), ``lr`` as a float. ``dtype`` is the activation dtype (bf16 runs
    under autocast). ``mark(name)``, when given, is called after each
    sub-step ('A', 'B', 'C') for timing; a profiled run marks the same
    stretches as the spans ``mcd.step_a``, ``mcd.step_b`` and
    ``mcd.step_c``. ``dp``: the data-parallel context (the batches are this
    rank's rows; the losses are the global batch's)."""
    disc = get_prob_distance_criterion(cfg.d_loss, dp)
    lr_fn = make_lr_schedule(cfg.lr_schedule, cfg.lr, cfg.max_steps, cfg.lr_power)
    num_k = cfg.num_k

    def step(state: MCDTrainState, xs: torch.Tensor, ys: torch.Tensor,
             xt: torch.Tensor, mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, object]:
        g, f1 = state.g, state.f1
        f2 = f1 if uses_one_classifier else state.f2
        lr = lr_fn(state.step)
        with span("mcd.step_a"):
            set_lr(state.opt_g, lr)
            set_lr(state.opt_f, lr)
            state.reseed_masks()

            # ---- STEP A: source supervision, update G + F1 + F2 ----
            state.opt_g.zero_grad(set_to_none=True)
            state.opt_f.zero_grad(set_to_none=True)
            with compute_context(dtype, xs.device):
                feat = g(xs)
                o1, o2 = f1(feat), f2(feat)
            loss_a = cross_entropy_2d(o1, ys, dp=dp) + cross_entropy_2d(o2, ys, dp=dp)
            loss_a.backward()
            zero_missing_grads(state.opt_f)
            all_reduce_grads(dp, state.opt_g, state.opt_f)
            state.opt_g.step()
            state.opt_f.step()
            del feat, o1, o2
        if mark:
            mark("A")
        with span("mcd.step_b"):
            loss_b = step_b(state, f2, xs, ys, xt, disc, dtype, dp)
        if mark:
            mark("B")
        with span("mcd.step_c"):
            loss_c = step_c(state, f2, xt, disc, dtype, num_k, dp)
        if mark:
            mark("C")

        state.step += 1
        return {"loss_source": loss_a.detach(), "loss_b": loss_b,
                "loss_dis": loss_c, "lr": lr}

    return step
