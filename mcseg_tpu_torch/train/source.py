"""Source-only supervised train step, eager PyTorch.

The port of the JAX package's ``train/source.py`` ``make_source_step``:
both classifiers are supervised on the same features, so that a source-only
checkpoint can seed MCD adaptation,

    loss = CE(F1(G(x)), y) + CE(F2(G(x)), y)

and G, F1 and F2 take one update each through the state's two optimizers,
with the schedule's lr set on both. G runs in train mode once per step, so
its BatchNorm statistics advance once and a G with dropout draws one set
of masks. Under a data-parallel context the loss and the BatchNorm
statistics are the global batch's and the gradients are averaged over the
ranks before the update (``train/mcd.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from mcseg_tpu_torch.core.config import TrainConfig
from mcseg_tpu_torch.core.device import compute_context
from mcseg_tpu_torch.losses.seg import cross_entropy_2d
from mcseg_tpu_torch.parallel.mesh import DataParallel, all_reduce_grads
from mcseg_tpu_torch.train.optim import make_lr_schedule, set_lr
from mcseg_tpu_torch.train.state import MCDTrainState


def make_source_step(cfg: TrainConfig, dtype: torch.dtype = torch.float32,
                     dp: Optional[DataParallel] = None) -> Callable:
    """``step(state, x, y) -> {'loss', 'lr'}``: ``x`` the preprocessed
    input, NCHW (channels_last memory; float64 under a float64 oracle),
    ``y`` the labels [B,H,W]. Updates ``state`` in place; ``loss`` is a
    detached scalar tensor on the device, ``lr`` a float. ``dp``: the
    data-parallel context, as in ``make_mcd_step``."""
    lr_fn = make_lr_schedule(cfg.lr_schedule, cfg.lr, cfg.max_steps, cfg.lr_power)

    def step(state: MCDTrainState, x: torch.Tensor, y: torch.Tensor) -> Dict[str, object]:
        lr = lr_fn(state.step)
        set_lr(state.opt_g, lr)
        set_lr(state.opt_f, lr)
        state.reseed_masks()
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_f.zero_grad(set_to_none=True)
        with compute_context(dtype, x.device):
            feat = state.g(x)
            o1, o2 = state.f1(feat), state.f2(feat)
        loss = cross_entropy_2d(o1, y, dp=dp) + cross_entropy_2d(o2, y, dp=dp)
        loss.backward()
        all_reduce_grads(dp, state.opt_g, state.opt_f)
        state.opt_g.step()
        state.opt_f.step()
        state.step += 1
        return {"loss": loss.detach(), "lr": lr}

    return step
