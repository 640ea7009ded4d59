"""Carry JAX/flax weights and optimizer state to and from the port.

``params_from_jax(params, batch_stats)`` takes the JAX trees as nested
dicts of numpy arrays (``{"G": ..., "F1": ..., "F2": ...}`` each, plus the
multitask trainer's "D" and "B" heads where present) and returns
``{"G": state_dict, "F1": ..., "F2": ...[, "D"][, "B"]}`` keyed by the
port's module names, which follow the flax tree:

  conv  ``kernel`` HWIO -> ``weight`` OIHW;  ``bias`` -> ``bias``
  BN    ``scale``/``bias`` -> ``weight``/``bias``;
        ``mean``/``var`` (batch_stats) -> ``running_mean``/``running_var``

It raises on any tensor it cannot place and on any BN that lacks its
parameters or its statistics. ``params_to_jax`` is its inverse, and
``opt_state_from_jax`` carries an optax ``trace`` (SGD momentum), a tree
shaped like the parameters, into ``torch.optim.SGD``'s momentum buffers.
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


def _param_tensors(params: Mapping):
    """Parameter-shaped JAX tree -> ({state-dict key: tensor}, BN modules)."""
    sd: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for path, arr in _flatten(params).items():
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
    return sd, bn_modules


def _module_state(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    sd, bn_modules = _param_tensors(params)
    s = _flatten(stats)
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
    """JAX ``{'G','F1','F2'[,'D'][,'B']}`` params + batch_stats -> port
    state dicts."""
    out = {}
    for name in ("G", "F1", "F2", "D", "B"):
        if name not in params:
            if name in ("D", "B"):  # only multitask checkpoints have them
                continue
            raise KeyError(f"JAX params have no {name!r} subtree")
        out[name] = _module_state(params[name], batch_stats.get(name, {}) or {})
    extra = (set(params) | set(batch_stats)) - set(out)
    if extra:
        raise KeyError(f"leftover JAX subtrees {sorted(extra)}")
    return out


def _nest(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    *mods, leaf = path.split(".")
    for m in mods:
        tree = tree.setdefault(m, {})
    tree[leaf] = value


def params_to_jax(params: Mapping[str, Mapping[str, torch.Tensor]]):
    """Port ``{"G", "F1", "F2"[, "D"][, "B"]}`` state dicts -> JAX-layout (params,
    batch_stats) trees of numpy arrays, the inverse of ``params_from_jax``
    (``num_batches_tracked``, which flax does not keep, is dropped)."""
    out_p: Dict[str, Any] = {}
    out_s: Dict[str, Any] = {}
    for name, sd in params.items():
        p, s = out_p.setdefault(name, {}), out_s.setdefault(name, {})
        for key, t in sd.items():
            mod, _, leaf = key.rpartition(".")
            prefix = f"{mod}." if mod else ""
            arr = t.detach().cpu().numpy()
            if leaf == "weight" and arr.ndim == 4:
                _nest(p, prefix + "kernel", np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
            elif leaf == "weight" and arr.ndim == 1:
                _nest(p, prefix + "scale", arr)
            elif leaf == "bias":
                _nest(p, prefix + "bias", arr)
            elif leaf in ("running_mean", "running_var"):
                _nest(s, prefix + leaf[len("running_"):], arr)
            elif leaf != "num_batches_tracked":
                raise KeyError(f"{name}: no JAX place for {key!r}")
    return out_p, out_s


@torch.no_grad()
def opt_state_from_jax(optimizer: torch.optim.Optimizer,
                       modules: Mapping[str, torch.nn.Module],
                       trace: Mapping[str, Mapping]) -> None:
    """Set each parameter's ``momentum_buffer`` in ``optimizer`` (an SGD
    over the parameters of ``modules``) from the optax ``trace`` tree of
    the same names, e.g. ``({"G": g}, {"G": trace_g})`` or
    ``({"F1": f1, "F2": f2, "D": d}, trace_f)``. Raises unless every
    parameter of the modules gets a buffer."""
    for name, module in modules.items():
        bufs, _ = _param_tensors(trace[name])
        named = dict(module.named_parameters())
        if bufs.keys() != named.keys():
            raise KeyError(f"{name}: trace keys {sorted(bufs.keys() ^ named.keys())} "
                           "do not match the module's parameters")
        for key, p in named.items():
            optimizer.state[p]["momentum_buffer"] = torch.empty_like(p).copy_(bufs[key])
