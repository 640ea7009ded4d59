"""Seed the port's modules from a reference torch checkpoint.

Reference checkpoints are torch dicts ``{epoch, args, g_state_dict,
f1_state_dict, f2_state_dict, ...}``, or bare trunk state dicts (ImageNet
weights). ``import_torch_state_dict`` fills one of the port's state dicts
(G, F1 or F2) from one of them, as the JAX package's
``utils/torch_import.py`` fills a flax tree, so an import gives JAX's
weights bit for bit:

  * the port's tensors are walked as JAX walks its flax leaves: parameters
    first, then BatchNorm statistics, each in natural-sort order of the
    flax path (``layer3/block0/bn1/scale``; the port's module names follow
    the flax tree, ``utils/jax_weights.py``), never in ``state_dict()``
    order, which would swap tensors of the same shape without an error;
  * each takes the first unused torch tensor of its category (a conv
    ``weight`` of 4 dims, a BN ``weight`` of 1, a ``bias``, a
    ``running_mean``, a ``running_var``) and shape, in the torch dict's
    order;
  * a kernel that finds none takes, with ``widen_first``, a 3-channel
    kernel widened by ``models.factory.widen_first_conv_params``, and
    failing that an FCN-style ``Linear`` of shape ``[O, ci*kh*kw]`` (how
    FCN8s convolutionalizes VGG16's fc6/fc7).

Both sides are OIHW, so nothing is transposed.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from mcseg_tpu_torch.models.factory import widen_first_conv_params

_STATS = {"running_mean": "mean", "running_var": "var"}


def _flax_path(key: str, t: torch.Tensor) -> Tuple[str, str]:
    """(collection, flax path) of a port state-dict key."""
    mod, _, leaf = key.rpartition(".")
    if leaf in _STATS:
        coll, name = "batch_stats", _STATS[leaf]
    elif leaf == "weight":
        coll, name = "params", "kernel" if t.ndim == 4 else "scale"
    elif leaf == "bias":
        coll, name = "params", "bias"
    else:
        raise KeyError(f"no flax place for {key!r}")
    return coll, "/".join(mod.split(".") + [name]) if mod else name


def _natural_key(path: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", path)]


def _ordered(state_dict: Dict[str, torch.Tensor]) -> List[Tuple[str, str, str, torch.Tensor]]:
    """(key, collection, flax path, tensor): parameters, then statistics,
    each in natural order of the flax path (JAX's ``_ordered_leaves``)."""
    out = {"params": [], "batch_stats": []}
    for key, t in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = _flax_path(key, t)
        out[coll].append((key, coll, path, t))
    return [item for coll in ("params", "batch_stats")
            for item in sorted(out[coll], key=lambda item: _natural_key(item[2]))]


def import_torch_state_dict(torch_sd: Dict[str, torch.Tensor],
                            state_dict: Dict[str, torch.Tensor],
                            widen_first: bool = True) -> Dict[str, torch.Tensor]:
    """A copy of the port state dict ``state_dict`` (one module) with every
    tensor taken from ``torch_sd`` (module docstring); raises if one finds
    no torch tensor."""
    items = [(k, torch.as_tensor(v).detach().cpu()) for k, v in torch_sd.items()
             if not k.endswith("num_batches_tracked")]
    used = [False] * len(items)

    def take(category: Callable[[str, torch.Tensor], bool], shape,
             transform: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
             ) -> Optional[torch.Tensor]:
        for i, (k, v) in enumerate(items):
            if used[i] or not category(k, v):
                continue
            tv = transform(v)
            if tuple(tv.shape) == tuple(shape):
                used[i] = True
                return tv
        return None

    def conv_weight(k, v):
        return k.endswith("weight") and v.ndim == 4

    out = dict(state_dict)
    for key, coll, path, cur in _ordered(state_dict):
        leaf = path.rpartition("/")[2]
        if leaf == "kernel":
            tv = take(conv_weight, cur.shape)
            if tv is None and widen_first and cur.shape[1] != 3:
                tv3 = take(conv_weight, (cur.shape[0], 3, *cur.shape[2:]))
                if tv3 is not None:
                    tv = widen_first_conv_params(tv3, cur.shape[1])
            if tv is None:
                co, ci, kh, kw = cur.shape
                tv = take(lambda k, v: k.endswith("weight")
                          and tuple(v.shape) == (co, ci * kh * kw),
                          cur.shape, lambda v: v.reshape(co, ci, kh, kw))
        elif leaf == "scale":
            tv = take(lambda k, v: k.endswith("weight") and v.ndim == 1, cur.shape)
        elif leaf == "bias":
            tv = take(lambda k, v: k.endswith("bias"), cur.shape)
        else:  # BN statistics
            suffix = "running_" + leaf
            tv = take(lambda k, v: k.endswith(suffix), cur.shape)
        if tv is None:
            raise ValueError(f"no torch tensor found for {coll}:{path} {tuple(cur.shape)}")
        out[key] = tv.to(cur.dtype).clone()
    return out

