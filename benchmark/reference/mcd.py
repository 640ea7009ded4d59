"""Plain reference of one MCD training iteration (Saito et al., "Maximum
Classifier Discrepancy for Unsupervised Domain Adaptation", CVPR 2018,
arXiv:1712.02560), with its losses and optimizer written out:

  A  minimize CE(F1(G(xs)), ys) + CE(F2(G(xs)), ys)        over G, F1, F2
  B  minimize CE terms - d(F1(G(xt)), F2(G(xt)))           over F1, F2;
     G forwards xs, then xt, in train mode without gradients
  C  minimize d(F1(G(xt)), F2(G(xt))) over G alone, num_k times, each
     with a fresh forward

CE is the mean over pixels whose label is not 255 (a sum over them divided
by their count, at least 1); d is the mean absolute difference of the two
softmax outputs over all pixels and classes. SGD: momentum 0.9 without
dampening or Nesterov, weight decay added to the gradient before the
momentum buffer, the learning rate of iteration i set once per iteration
by the poly schedule lr * (1 - i / max_steps) ** power. G's BatchNorm
advances in every forward, in the order A: xs; B: xs, xt; C: xt x num_k.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.drn import recomputing

IGNORE = 255


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    labels = labels.long()
    valid = labels != IGNORE
    logp = torch.log_softmax(_at_least_f32(logits), dim=1)
    picked = logp.gather(1, torch.where(valid, labels, 0)[:, None])[:, 0]
    return -(picked * valid).sum() / valid.sum().clamp(min=1)


def discrepancy(o1: torch.Tensor, o2: torch.Tensor) -> torch.Tensor:
    p1, p2 = torch.softmax(_at_least_f32(o1), dim=1), torch.softmax(_at_least_f32(o2), dim=1)
    return (p1 - p2).abs().mean()


class SGD:
    """Momentum SGD over ``params``, one buffer per parameter."""

    def __init__(self, params: List[torch.nn.Parameter], momentum: float, weight_decay: float):
        self.params = list(params)
        self.momentum, self.weight_decay = momentum, weight_decay
        self.buf: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        for i, (p, g) in enumerate(zip(self.params, grads)):
            d = g + self.weight_decay * p
            self.buf[i] = d.clone() if i not in self.buf else self.buf[i].mul_(
                self.momentum).add_(d)
            p.sub_(lr * self.buf[i])


def poly_lr(train: Dict, iteration: int) -> float:
    frac = min(max(iteration / train["max_steps"], 0.0), 1.0)
    return train["lr"] * (1.0 - frac) ** train["lr_power"]


class MCD:
    """The modules and both optimizers; ``iteration(xs, ys, xt)`` runs one
    MCD iteration and returns its three losses (A's, B's and the last C's),
    detached. ``first_grads`` holds the gradients of step A of the first
    iteration, by parameter name, and ``stats_a`` G's BatchNorm running
    statistics after that step, by ``G.<key>``."""

    def __init__(self, g, f1, f2, train: Dict):
        self.mods = {"G": g, "F1": f1, "F2": f2}
        self.train = train
        self.g_params = list(g.parameters())
        self.f_params = list(f1.parameters()) + list(f2.parameters())
        self.opt_g = SGD(self.g_params, train["momentum"], train["weight_decay"])
        self.opt_f = SGD(self.f_params, train["momentum"], train["weight_decay"])
        self.step = 0
        self.first_grads: Dict[str, torch.Tensor] = {}
        self.stats_a: Dict[str, torch.Tensor] = {}

    def named_params(self):
        return [(f"{n}.{k}", p) for n, m in self.mods.items() for k, p in m.named_parameters()]

    def iteration(self, xs, ys, xt) -> Dict[str, float]:
        g, f1, f2 = self.mods["G"], self.mods["F1"], self.mods["F2"]
        lr = poly_lr(self.train, self.step)
        feat = g(xs)
        loss_a = cross_entropy(f1(feat), ys) + cross_entropy(f2(feat), ys)
        with recomputing():
            grads = torch.autograd.grad(loss_a, self.g_params + self.f_params)
        if self.step == 0:
            names = [n for n, _ in self.named_params()]
            self.first_grads = {n: gr.detach().clone() for n, gr in zip(names, grads)}
            self.stats_a = {f"G.{k}": v.clone() for k, v in g.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))}
        ng = len(self.g_params)
        self.opt_g.step(grads[:ng], lr)
        self.opt_f.step(grads[ng:], lr)
        del feat, grads

        with torch.no_grad():
            feat_s, feat_t = g(xs), g(xt)
        loss_b = (cross_entropy(f1(feat_s), ys) + cross_entropy(f2(feat_s), ys)
                  - discrepancy(f1(feat_t), f2(feat_t)))
        with recomputing():
            self.opt_f.step(torch.autograd.grad(loss_b, self.f_params), lr)
        del feat_s, feat_t

        for _ in range(self.train["num_k"]):
            feat_t = g(xt)
            loss_c = discrepancy(f1(feat_t), f2(feat_t))
            with recomputing():
                self.opt_g.step(torch.autograd.grad(loss_c, self.g_params), lr)
            del feat_t
        self.step += 1
        return {"loss_source": loss_a.detach(), "loss_b": loss_b.detach(),
                "loss_dis": loss_c.detach()}
