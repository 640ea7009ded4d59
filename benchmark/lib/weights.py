"""Seeded weights, made on the card in one draw.

The names and shapes are those of the reference's modules (which are the
program's state-dict keys). Trunk convolutions are N(0, 2 / (k * k *
out_channels)) (DRN's He initialization, fan-out); the heads' score convs
N(0, 1 / in_channels) with zero bias; BatchNorm scale 1, shift 0, running
mean 0 and variance 1. One ``torch.randn`` over every weight, scaled per
leaf, float32 (the parameter dtype under bfloat16 autocast).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference.drn import build_models

Params = Dict[str, Dict[str, torch.Tensor]]


def _std(module: str, key: str, shape) -> float:
    if module == "G":
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    return math.sqrt(1.0 / shape[1])


def make_params(model: Dict, gen: torch.Generator) -> Params:
    dev = gen.device
    with torch.device("meta"):
        mods = dict(zip(("G", "F1", "F2"), build_models(model)))
    drawn = [(n, k, t.shape) for n, m in mods.items() for k, t in m.state_dict().items()
             if k.endswith("weight") and t.dim() == 4]
    counts = torch.tensor([math.prod(s) for _, _, s in drawn], device=dev)
    stds = torch.tensor([_std(n, k, s) for n, k, s in drawn], device=dev)
    flat = torch.randn(int(counts.sum()), generator=gen, device=dev)
    flat.mul_(torch.repeat_interleave(stds, counts))
    chunks = iter(flat.split(counts.tolist()))
    out: Params = {}
    for n, m in mods.items():
        out[n] = {}
        for k, t in m.state_dict().items():
            if k.endswith("weight") and t.dim() == 4:
                out[n][k] = next(chunks).view(t.shape)
            elif k.endswith("running_var") or k.endswith("weight"):
                out[n][k] = torch.ones(t.shape, dtype=t.dtype, device=dev)
            else:
                out[n][k] = torch.zeros(t.shape, dtype=t.dtype, device=dev)
    return out
