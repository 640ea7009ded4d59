"""MCD train state: the three modules, their two optimizers, the iteration
counter and a random generator.

The port of the JAX package's ``train/state.py``. JAX carries one explicit
pytree through a jitted step; here the state is a mutable holder that the
eager step updates in place:

  g, f1, f2   the trunk and both heads on the device (float32 parameters
              and BatchNorm statistics; float64 under a float64 oracle),
              NCHW modules in channels_last memory, in train mode
  opt_g       optimizer over G
  opt_f       optimizer over F1 and F2 together
  step        per-iteration counter driving the lr schedule
  gen         CPU ``torch.Generator`` that made the initial weights
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.core.device import compute_dtype, resolve_device
from mcseg_tpu_torch.models.factory import Params, get_models, init_models
from mcseg_tpu_torch.train.optim import get_optimizer


@dataclass
class MCDTrainState:
    g: nn.Module
    f1: nn.Module
    f2: nn.Module
    opt_g: torch.optim.Optimizer
    opt_f: torch.optim.Optimizer
    step: int
    gen: torch.Generator

    def params(self) -> Params:
        """``{"G", "F1", "F2"}`` state dicts, detached copies on the CPU."""
        return {name: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                for name, m in (("G", self.g), ("F1", self.f1), ("F2", self.f2))}


def param_dtype(model_cfg: ModelConfig) -> torch.dtype:
    return torch.float64 if compute_dtype(model_cfg.dtype) == torch.float64 else torch.float32


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0,
                       device="cuda", params: Optional[Params] = None) -> MCDTrainState:
    """Seeded parameters for (G, F1, F2) (``models.factory.init_models``
    with a generator seeded by ``seed``), or ``params`` when given, on
    ``device``, with fresh optimizers from ``train_cfg``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        params = init_models(model_cfg, gen)
    mods = [m.to(param_dtype(model_cfg)) for m in get_models(model_cfg)]
    for m, name in zip(mods, ("G", "F1", "F2")):
        m.load_state_dict(params[name])
    g, f1, f2 = (m.to(dev).to(memory_format=torch.channels_last).train() for m in mods)
    opt = dict(opt=train_cfg.opt, lr=train_cfg.lr, momentum=train_cfg.momentum,
               weight_decay=train_cfg.weight_decay)
    opt_g = get_optimizer(g.parameters(), **opt)
    opt_f = get_optimizer(list(f1.parameters()) + list(f2.parameters()), **opt)
    return MCDTrainState(g=g, f1=f1, f2=f2, opt_g=opt_g, opt_f=opt_f, step=0, gen=gen)
