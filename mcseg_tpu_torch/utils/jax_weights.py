"""Carry JAX/flax weights across to the port's state dicts.

``params_from_jax(params, batch_stats)`` takes the JAX trees as nested
dicts of numpy arrays (``{"G": ..., "F1": ..., "F2": ...}`` each) and
returns ``{"G": state_dict, "F1": ..., "F2": ...}`` keyed by the port's
module names, which follow the flax tree:

  conv  ``kernel`` HWIO -> ``weight`` OIHW;  ``bias`` -> ``bias``
  BN    ``scale``/``bias`` -> ``weight``/``bias``;
        ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``

It raises on any tensor it cannot place and on any BN that lacks its
parameters or its statistics.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _module_state(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    p = _flatten(params)
    s = _flatten(stats)
    sd: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for path, arr in p.items():
        mod, _, leaf = path.rpartition(".")
        prefix = f"{mod}." if mod else ""
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{path}: expected an HWIO conv kernel, got {arr.shape}")
            sd[prefix + "weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "scale":
            sd[prefix + "weight"] = torch.from_numpy(np.array(arr))
            bn_modules.add(mod)
        elif leaf == "bias":
            sd[prefix + "bias"] = torch.from_numpy(np.array(arr))
        else:
            raise KeyError(f"unmatched JAX parameter {path!r}")
    for path, arr in s.items():
        mod, _, leaf = path.rpartition(".")
        prefix = f"{mod}." if mod else ""
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names or mod not in bn_modules:
            raise KeyError(f"leftover JAX batch statistic {path!r}")
        sd[prefix + names[leaf]] = torch.from_numpy(np.array(arr))
    for mod in bn_modules:
        prefix = f"{mod}." if mod else ""
        for name in ("running_mean", "running_var"):
            if prefix + name not in sd:
                raise KeyError(f"BatchNorm {mod!r} has no {name} in batch_stats")
        sd[prefix + "num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def params_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX ``{'G','F1','F2'}`` params + batch_stats -> port state dicts."""
    out = {}
    for name in ("G", "F1", "F2"):
        if name not in params:
            raise KeyError(f"JAX params have no {name!r} subtree")
        out[name] = _module_state(params[name], batch_stats.get(name, {}) or {})
    extra = (set(params) | set(batch_stats)) - set(out)
    if extra:
        raise KeyError(f"leftover JAX subtrees {sorted(extra)}")
    return out
