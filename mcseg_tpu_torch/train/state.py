"""Train state: the modules, their two optimizers, the iteration counter and
a random generator.

The port of the JAX package's ``train/state.py`` (and of
``train/multitask.py:init_multitask_state``). JAX carries one explicit
pytree through a jitted step; here the state is a mutable holder that the
eager step updates in place:

  g, f1, f2   the trunk and both heads on the device (float32 parameters
              and BatchNorm statistics; float64 under a float64 oracle),
              NCHW modules in channels_last memory, in train mode
  d, b        the multitask trainer's depth head and optional boundary
              head (None otherwise)
  opt_g       optimizer over G
  opt_f       optimizer over F1, F2 and the auxiliary heads, in checkpoint
              order (F1, F2, D, B)
  step        per-iteration counter driving the lr schedule
  gen         CPU ``torch.Generator`` that made the initial weights
  masks       the dropout mask source of G (``models.fcn_vgg.SeededMasks``
              on the device, seeded from (seed, step)), or None for a
              trunk without dropout; the steps call ``reseed_masks`` first

Under data parallelism every rank holds a replica: ``set_data_parallel``
makes G's BatchNorm and dropout masks those of the global batch, and
``broadcast_from_primary`` copies rank 0's replica to every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.core.device import compute_dtype, resolve_device
from mcseg_tpu_torch.models.factory import (
    Params, get_aux_heads, get_models, init_aux_heads, init_models)
from mcseg_tpu_torch.models.drn import set_data_parallel
from mcseg_tpu_torch.models.fcn_vgg import (
    MaskSource, SeededMasks, dropout_layers, set_mask_source)
from mcseg_tpu_torch.parallel.mesh import DataParallel, broadcast_tensors
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
    d: Optional[nn.Module] = None
    b: Optional[nn.Module] = None
    masks: Optional[MaskSource] = None

    def modules(self) -> Dict[str, nn.Module]:
        """``{"G", "F1", "F2"[, "D"][, "B"]}`` in checkpoint order."""
        mods = {"G": self.g, "F1": self.f1, "F2": self.f2, "D": self.d, "B": self.b}
        return {k: m for k, m in mods.items() if m is not None}

    def params(self) -> Params:
        """The modules' state dicts, detached copies on the CPU."""
        return {name: {k: v.detach().cpu().clone() for k, v in m.state_dict().items()}
                for name, m in self.modules().items()}

    def install_masks(self, source: MaskSource) -> None:
        """Make ``source`` G's dropout mask source."""
        set_mask_source(self.g, source)
        self.masks = source

    def set_data_parallel(self, dp: Optional[DataParallel]) -> None:
        """Make the BatchNorm statistics of every module, and G's seeded
        dropout masks, those of ``dp``'s global batch (None: the local
        batch's)."""
        for m in self.modules().values():
            set_data_parallel(m, dp)
        if isinstance(self.masks, SeededMasks):
            self.masks.data_parallel = dp

    def broadcast_from_primary(self, dp: Optional[DataParallel]) -> None:
        """Overwrite this replica with rank 0's: parameters, BatchNorm
        statistics, both optimizers' states and ``step`` (a no-op without a
        group). Every rank must hold states of the same structure."""
        if dp is None:
            return
        tensors = [t for m in self.modules().values() for t in m.state_dict().values()]
        for opt in (self.opt_g, self.opt_f):
            for group in opt.param_groups:
                for p in group["params"]:
                    tensors += [v for _, v in sorted(opt.state.get(p, {}).items())
                                if isinstance(v, torch.Tensor)]
        step = torch.tensor([self.step], dtype=torch.int64)
        broadcast_tensors(dp, tensors + [step])
        self.step = int(step.item())

    def reseed_masks(self) -> None:
        """Seed this iteration's dropout masks from the step (a no-op
        without dropout): every step calls it before its first G forward."""
        if self.masks is not None:
            self.masks.reseed(self.step)


def param_dtype(model_cfg: ModelConfig) -> torch.dtype:
    return torch.float64 if compute_dtype(model_cfg.dtype) == torch.float64 else torch.float32


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig, seed: int = 0,
                       device="cuda", params: Optional[Params] = None,
                       aux_heads: Sequence[str] = ()) -> MCDTrainState:
    """Seeded parameters for (G, F1, F2) and the auxiliary heads
    ``aux_heads`` ("D", "B"; ``models.factory.init_models`` then
    ``init_aux_heads`` with one generator seeded by ``seed``), or
    ``params`` when given, on ``device``, with fresh optimizers from
    ``train_cfg``. A G with dropout gets ``SeededMasks(seed)`` on
    ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    aux = get_aux_heads(model_cfg, aux_heads)
    if params is None:
        params = init_models(model_cfg, gen)
        params.update(init_aux_heads(model_cfg, aux_heads, gen))
    mods = dict(zip(("G", "F1", "F2"), get_models(model_cfg)), **aux)
    for name, m in mods.items():
        m.to(param_dtype(model_cfg)).load_state_dict(params[name])
        m.to(dev).to(memory_format=torch.channels_last).train()
    opt = dict(opt=train_cfg.opt, lr=train_cfg.lr, momentum=train_cfg.momentum,
               weight_decay=train_cfg.weight_decay)
    opt_g = get_optimizer(mods["G"].parameters(), **opt)
    opt_f = get_optimizer([p for k, m in mods.items() if k != "G" for p in m.parameters()],
                          **opt)
    state = MCDTrainState(g=mods["G"], f1=mods["F1"], f2=mods["F2"], opt_g=opt_g,
                          opt_f=opt_f, step=0, gen=gen, d=mods.get("D"), b=mods.get("B"))
    if dropout_layers(state.g):
        state.install_masks(SeededMasks(seed, dev))
    return state
