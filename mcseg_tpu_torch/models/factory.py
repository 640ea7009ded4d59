"""Model factory: (G, F1, F2) for a ModelConfig, and seeded initialization.

The trunks: every DRN (``models/drn.py``; two of them under late fusion),
FCN8s on VGG16 (``models/fcn_vgg.py``) and PSPNet (``models/psp_net.py``),
under the JAX package's names for each.

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
from mcseg_tpu_torch.models.fcn_vgg import FCN8sClassifier, VGG16FeatureGenerator
from mcseg_tpu_torch.models.fusion import LateFusionClassifier, LateFusionGenerator
from mcseg_tpu_torch.models.heads import BoundaryDetector, DepthRegressor, PixelClassifier
from mcseg_tpu_torch.models.psp_net import PSPFeatureGenerator
from mcseg_tpu_torch.parallel.spatial import FCN_NETS

Params = Dict[str, Dict[str, torch.Tensor]]
AUX_HEADS = {"D": DepthRegressor, "B": BoundaryDetector}  # in checkpoint order
PSP_NETS = ("psp", "psp_net", "pspnet")


def get_models(cfg: ModelConfig) -> Tuple[nn.Module, nn.Module, nn.Module]:
    """Build (G, F1, F2) modules for a ModelConfig: one trunk (single
    modality or early fusion) or two DRN trunks (late fusion)."""
    if cfg.fusion == "late" and cfg.input_ch != 6:
        # the generator splits channels [0:3] rgb / [3:6] hha; any other
        # input_ch would drop or misroute planes
        raise ValueError(
            f"--fusion late requires --input_ch 6 (rgb+hha), got "
            f"input_ch={cfg.input_ch}; use early fusion (single trunk) "
            "for other channel stacks")
    if cfg.fusion == "late" and cfg.net not in drn_variants():
        # the JAX package's LateFusionGenerator builds DRN trunks only and
        # fails on its first forward
        raise ValueError(f"--fusion late builds two DRN trunks: unknown DRN variant "
                         f"{cfg.net!r}; options: {sorted(drn_variants())}")
    if cfg.fusion == "late":
        g, head = LateFusionGenerator(cfg.net), LateFusionClassifier
    elif cfg.net in FCN_NETS:
        g, head = VGG16FeatureGenerator(cfg.input_ch), FCN8sClassifier
    elif cfg.net in PSP_NETS:
        g, head = PSPFeatureGenerator(cfg.input_ch), PixelClassifier
    elif cfg.net in drn_variants():
        g, head = build_drn(cfg.net, input_ch=cfg.input_ch), PixelClassifier
    else:
        raise ValueError(f"unknown --net {cfg.net!r}; options: "
                         f"{sorted(drn_variants() + FCN_NETS + PSP_NETS)}")
    f1 = head(g.out_dim, cfg.n_class, upsample=cfg.upsample)
    f2 = head(g.out_dim, cfg.n_class, upsample=cfg.upsample)
    return g, f1, f2


def get_aux_heads(cfg: ModelConfig, keys: Sequence[str]) -> Dict[str, nn.Module]:
    """The multitask trainer's auxiliary heads named by ``keys`` ("D",
    "B"), on the trunk's features. Late fusion and FCN8s have no single
    feature map for them (their G returns an (rgb, hha) pair or three skip
    maps, which the JAX package's multitask initializer cannot take
    either), so they raise."""
    if keys and cfg.fusion == "late":
        raise ValueError(
            "multitask training needs a single-trunk generator: under --fusion "
            "late G returns an (rgb, hha) feature pair, which the depth and "
            "boundary heads cannot take; use --fusion single (early fusion)")
    if keys and cfg.net in FCN_NETS:
        raise ValueError(
            f"multitask training needs one feature map: --net {cfg.net} returns "
            "three skip maps (pool3, pool4, drop7), which the depth and boundary "
            "heads cannot take; use a DRN trunk or --net psp")
    in_ch = PSPFeatureGenerator.out_dim if cfg.net in PSP_NETS else CHANNELS[-1]
    return {k: AUX_HEADS[k](in_ch, upsample=cfg.upsample) for k in keys}


def _lecun_normal_(conv: nn.Conv2d, gen: torch.Generator) -> None:
    # flax's default: LeCun-normal truncated at 2 sigma (variance-corrected),
    # zero bias
    w = conv.weight
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    # inverse-CDF sampling of N(0, std) truncated to [-2 std, 2 std], as
    # torch's trunc_normal_ long did: one pass over the tensor (newer
    # versions may resample the whole tensor until no element is out of
    # range, ~10 s for conv6's 103 M)
    cdf = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    w.uniform_(2.0 * cdf - 1.0, 1.0 - 2.0 * cdf, generator=gen)
    w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
    conv.bias.zero_()


@torch.no_grad()
def _init_trunk(g: nn.Module, gen: torch.Generator) -> None:
    for m in g.modules():
        if isinstance(m, nn.Conv2d) and m.bias is not None:
            _lecun_normal_(m, gen)  # a plain flax nn.Conv: the VGG trunk's
        elif isinstance(m, nn.Conv2d):
            # DRN convention (DRN, PSP): N(0, sqrt(2 / (k*k*out_ch))) —
            # Kaiming-normal, fan-out
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()  # scale 1, bias 0, mean 0, var 1


@torch.no_grad()
def _init_head(f: nn.Module, gen: torch.Generator) -> None:
    # each score conv: one, two under late fusion, three in FCN8s
    for m in f.modules():
        if isinstance(m, nn.Conv2d):
            _lecun_normal_(m, gen)


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


def widen_first_conv_params(kernel3: torch.Tensor, input_ch: int) -> torch.Tensor:
    """Widen an OIHW first-conv kernel from 3 input channels to
    ``input_ch``, as the JAX package's ``widen_first_conv_params`` does on
    HWIO: the RGB slice keeps its weights and each extra channel (depth,
    HHA) takes the RGB channel mean, so first activations keep a similar
    scale; ``input_ch`` 1 takes the channel sum (a grayscale projection)."""
    ci = kernel3.shape[1]
    if ci != 3:
        raise ValueError(f"expected a 3-input-channel kernel, got {ci}")
    if input_ch == 3:
        return kernel3
    # summed left to right, then times 1/3 in the kernel's dtype: the JAX
    # package's mean, as XLA computes it
    total = kernel3[:, 0:1] + kernel3[:, 1:2] + kernel3[:, 2:3]
    if input_ch == 1:
        return total
    mean = total * torch.tensor(1.0 / 3.0, dtype=kernel3.dtype)
    return torch.cat([kernel3, mean.expand(-1, input_ch - 3, -1, -1)], dim=1)
