"""Model factory: (G, F1, F2) for a ModelConfig, and seeded initialization.

Parameters travel as ``{"G": state_dict, "F1": state_dict, "F2":
state_dict}`` of float32 CPU tensors — the form ``init_models`` makes,
``utils.jax_weights.params_from_jax`` carries over from JAX, and the entry
points load onto their device. The multitask trainer adds a depth head
"D" and optionally a boundary head "B" (``get_aux_heads``,
``init_aux_heads``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from mcseg_tpu_torch.core.config import ModelConfig
from mcseg_tpu_torch.models.drn import CHANNELS, build_drn, drn_variants
from mcseg_tpu_torch.models.fusion import LateFusionClassifier, LateFusionGenerator
from mcseg_tpu_torch.models.heads import BoundaryDetector, DepthRegressor, PixelClassifier

Params = Dict[str, Dict[str, torch.Tensor]]
AUX_HEADS = {"D": DepthRegressor, "B": BoundaryDetector}  # in checkpoint order


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


def get_aux_heads(cfg: ModelConfig, keys: Sequence[str]) -> Dict[str, nn.Module]:
    """The multitask trainer's auxiliary heads named by ``keys`` ("D",
    "B"), on the trunk's features. Late fusion has no single feature map
    for them (its G returns an (rgb, hha) pair, which the JAX package's
    multitask initializer cannot take either), so it raises."""
    if keys and cfg.fusion == "late":
        raise ValueError(
            "multitask training needs a single-trunk generator: under --fusion "
            "late G returns an (rgb, hha) feature pair, which the depth and "
            "boundary heads cannot take; use --fusion single (early fusion)")
    # every DRN trunk ends at CHANNELS[-1] channels
    return {k: AUX_HEADS[k](CHANNELS[-1], upsample=cfg.upsample) for k in keys}


def _lecun_normal_(conv: nn.Conv2d, gen: torch.Generator) -> None:
    # flax's default: LeCun-normal truncated at 2 sigma (variance-corrected),
    # zero bias
    w = conv.weight
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
    conv.bias.zero_()


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
    # each score conv (two under late fusion)
    for m in f.modules():
        if isinstance(m, PixelClassifier):
            _lecun_normal_(m.score, gen)


def init_models(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Seeded float32 parameters for (G, F1, F2), made on the CPU."""
    g, f1, f2 = get_models(cfg)
    _init_trunk(g, gen)
    _init_head(f1, gen)
    _init_head(f2, gen)
    return {"G": g.state_dict(), "F1": f1.state_dict(), "F2": f2.state_dict()}


@torch.no_grad()
def init_aux_heads(cfg: ModelConfig, keys: Sequence[str], gen: torch.Generator) -> Params:
    """Seeded float32 parameters of the auxiliary heads ``keys``, drawn
    from ``gen`` in checkpoint order after G, F1 and F2."""
    heads = get_aux_heads(cfg, keys)
    for head in heads.values():
        _lecun_normal_(head.conv, gen)
    return {k: head.state_dict() for k, head in heads.items()}
