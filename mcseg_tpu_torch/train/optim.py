"""Optimizers and learning-rate schedules.

The port of the JAX package's ``train/optim.py``, whose optax chains follow
torch's own update rules, so the port uses torch's optimizers:

  * sgd  : ``torch.optim.SGD(momentum, weight_decay, dampening=0)`` — decay
           added to the gradient before the momentum buffer, no Nesterov;
  * adam : ``torch.optim.Adam(weight_decay)`` — L2 added to the gradient
           before the moments, not AdamW.

Schedules are plain functions of the iteration, in float64 on the host;
``set_lr`` writes the value into every parameter group once per iteration,
however many optimizer updates the MCD iteration makes.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def poly_lr(base_lr: float, max_steps: int, power: float = 0.9) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        frac = min(max(step / max_steps, 0.0), 1.0)
        return base_lr * (1.0 - frac) ** power

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.1) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return base_lr * gamma ** float(step // step_size)

    return schedule


def constant_lr(base_lr: float) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return float(base_lr)

    return schedule


def make_lr_schedule(kind: str, base_lr: float, max_steps: int,
                     power: float = 0.9) -> Callable[[int], float]:
    if kind == "poly":
        return poly_lr(base_lr, max_steps, power)
    if kind == "constant":
        return constant_lr(base_lr)
    if kind == "step":
        return step_lr(base_lr, max(max_steps // 3, 1))
    raise ValueError(f"unknown lr schedule {kind!r}")


def get_optimizer(params: Iterable[torch.nn.Parameter], opt: str = "sgd",
                  lr: float = 1e-3, momentum: float = 0.9,
                  weight_decay: float = 2e-5) -> torch.optim.Optimizer:
    if opt == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                               weight_decay=weight_decay)
    if opt == "adam":
        return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {opt!r} (options: sgd, adam)")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
