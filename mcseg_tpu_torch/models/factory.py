"""Model factory: (G, F1, F2) for a ModelConfig, and seeded initialization.

Parameters travel as ``{"G": state_dict, "F1": state_dict, "F2":
state_dict}`` of float32 CPU tensors — the form ``init_models`` makes,
``utils.jax_weights.params_from_jax`` carries over from JAX, and the entry
points load onto their device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from mcseg_tpu_torch.core.config import ModelConfig
from mcseg_tpu_torch.models.drn import build_drn, drn_variants
from mcseg_tpu_torch.models.fusion import LateFusionClassifier, LateFusionGenerator
from mcseg_tpu_torch.models.heads import PixelClassifier

Params = Dict[str, Dict[str, torch.Tensor]]


def get_models(cfg: ModelConfig) -> Tuple[nn.Module, nn.Module, nn.Module]:
    """Build (G, F1, F2) modules for a ModelConfig: one DRN trunk (single
    modality or early fusion) or two (late fusion)."""
    if cfg.fusion == "late" and cfg.input_ch != 6:
        # the generator splits channels [0:3] rgb / [3:6] hha; any other
        # input_ch would drop or misroute planes
        raise ValueError(
            f"--fusion late requires --input_ch 6 (rgb+hha), got "
            f"input_ch={cfg.input_ch}; use early fusion (single trunk) "
            "for other channel stacks")
    if cfg.net not in drn_variants():
        raise ValueError(f"--net {cfg.net!r} is not ported yet (fcn8s_vgg16 and "
                         f"psp are not); options: {sorted(drn_variants())}")
    if cfg.fusion == "late":
        g, head = LateFusionGenerator(cfg.net), LateFusionClassifier
    else:
        g, head = build_drn(cfg.net, input_ch=cfg.input_ch), PixelClassifier
    f1 = head(g.out_dim, cfg.n_class, upsample=cfg.upsample)
    f2 = head(g.out_dim, cfg.n_class, upsample=cfg.upsample)
    return g, f1, f2


@torch.no_grad()
def _init_trunk(g: nn.Module, gen: torch.Generator) -> None:
    # DRN convention: N(0, sqrt(2 / (k*k*out_ch))) — Kaiming-normal, fan-out
    for m in g.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # scale 1, bias 0, mean 0, var 1


@torch.no_grad()
def _init_head(f: nn.Module, gen: torch.Generator) -> None:
    # LeCun-normal (truncated at 2 sigma, variance-corrected), zero bias,
    # for each score conv (two under late fusion)
    for m in f.modules():
        if isinstance(m, PixelClassifier):
            w = m.score.weight
            std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.score.bias.zero_()


def init_models(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Seeded float32 parameters for (G, F1, F2), made on the CPU."""
    g, f1, f2 = get_models(cfg)
    _init_trunk(g, gen)
    _init_head(f1, gen)
    _init_head(f2, gen)
    return {"G": g.state_dict(), "F1": f1.state_dict(), "F2": f2.state_dict()}
