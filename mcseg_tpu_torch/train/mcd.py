"""MCD adaptation iteration, eager PyTorch.

The port of the JAX package's ``train/mcd.py`` ``make_mcd_step`` (Saito et
al., CVPR 2018, Maximum Classifier Discrepancy):

  STEP A  minimize CE(F1(G(xs)), ys) + CE(F2(G(xs)), ys)      wrt G, F1, F2
  STEP B  minimize CE terms  -  d(F1(G(xt)), F2(G(xt)))        wrt F1, F2 only
  STEP C  minimize d(F1(G(xt)), F2(G(xt)))                     wrt G only,
          num_k times, each with a fresh forward

G stays in train mode throughout, so its BatchNorm statistics advance in
every forward, in the order A: xs; B: xs, xt; C: xt x num_k. In step B G
runs under ``no_grad``; in step C only G's gradients are taken
(``torch.autograd.grad``), so neither head nor opt_f's momentum moves.

``uses_one_classifier`` applies F1 in F2's place. F2 then gets a zero
gradient rather than none, so that its optimizer still applies weight
decay (and momentum) to it, as optax does in the JAX step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mcseg_tpu_torch.core.config import TrainConfig
from mcseg_tpu_torch.core.device import compute_context
from mcseg_tpu_torch.losses.discrepancy import get_prob_distance_criterion
from mcseg_tpu_torch.losses.seg import cross_entropy_2d
from mcseg_tpu_torch.train.optim import make_lr_schedule, set_lr
from mcseg_tpu_torch.train.state import MCDTrainState


def _zero_missing_grads(module: torch.nn.Module) -> None:
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_mcd_step(cfg: TrainConfig, uses_one_classifier: bool = False,
                  dtype: torch.dtype = torch.float32) -> Callable:
    """``step(state, xs, ys, xt, mark=None) -> metrics``.

    ``xs``/``xt`` are the preprocessed source and target inputs, NCHW
    (channels_last memory; float64 under a float64 oracle), ``ys`` the
    source labels [B,H,W]. The step updates ``state`` in place and returns
    ``{'loss_source', 'loss_b', 'loss_dis', 'lr'}``: the losses as detached
    scalar tensors on the device (read them only where the host needs
    them), ``lr`` as a float. ``dtype`` is the activation dtype (bf16 runs
    under autocast). ``mark(name)``, when given, is called after each
    sub-step ('A', 'B', 'C') for timing."""
    disc = get_prob_distance_criterion(cfg.d_loss)
    lr_fn = make_lr_schedule(cfg.lr_schedule, cfg.lr, cfg.max_steps, cfg.lr_power)
    num_k = cfg.num_k

    def step(state: MCDTrainState, xs: torch.Tensor, ys: torch.Tensor,
             xt: torch.Tensor, mark: Optional[Callable[[str], None]] = None
             ) -> Dict[str, object]:
        g, f1 = state.g, state.f1
        f2 = f1 if uses_one_classifier else state.f2
        lr = lr_fn(state.step)
        set_lr(state.opt_g, lr)
        set_lr(state.opt_f, lr)

        # ---- STEP A: source supervision, update G + F1 + F2 ----
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_f.zero_grad(set_to_none=True)
        with compute_context(dtype, xs.device):
            feat = g(xs)
            o1, o2 = f1(feat), f2(feat)
        loss_a = cross_entropy_2d(o1, ys) + cross_entropy_2d(o2, ys)
        loss_a.backward()
        if uses_one_classifier:
            _zero_missing_grads(state.f2)
        state.opt_g.step()
        state.opt_f.step()
        del feat, o1, o2
        if mark:
            mark("A")

        # ---- STEP B: maximize the discrepancy wrt F1, F2 (G frozen) ----
        state.opt_f.zero_grad(set_to_none=True)
        with compute_context(dtype, xs.device):
            with torch.no_grad():
                feat_s = g(xs)
                feat_t = g(xt)
            o1s, o2s = f1(feat_s), f2(feat_s)
            o1t, o2t = f1(feat_t), f2(feat_t)
        loss_b = (cross_entropy_2d(o1s, ys) + cross_entropy_2d(o2s, ys)
                  - disc(o1t, o2t))
        loss_b.backward()
        if uses_one_classifier:
            _zero_missing_grads(state.f2)
        state.opt_f.step()
        del feat_s, feat_t, o1s, o2s, o1t, o2t
        if mark:
            mark("B")

        # ---- STEP C: minimize the discrepancy wrt G (F frozen), x num_k ----
        g_params = [p for p in g.parameters() if p.requires_grad]
        for _ in range(num_k):
            with compute_context(dtype, xs.device):
                feat_t = g(xt)
                o1t, o2t = f1(feat_t), f2(feat_t)
            loss_c = disc(o1t, o2t)
            grads = torch.autograd.grad(loss_c, g_params)
            for p, grad in zip(g_params, grads):
                p.grad = grad
            state.opt_g.step()
            del feat_t, o1t, o2t, grads
        if mark:
            mark("C")

        state.step += 1
        return {"loss_source": loss_a.detach(), "loss_b": loss_b.detach(),
                "loss_dis": loss_c.detach(), "lr": lr}

    return step
