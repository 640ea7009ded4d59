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
parameters or its statistics. ``params_to_jax`` is its inverse.

Optimizer state: ``opt_state_from_jax`` carries an optax ``trace`` (SGD
momentum), a tree shaped like the parameters, into ``torch.optim.SGD``'s
momentum buffers, and ``adam_state_from_jax`` carries ``scale_by_adam``'s
``{count, mu, nu}`` into ``torch.optim.Adam``'s ``{step, exp_avg,
exp_avg_sq}``. ``opt_state_to_jax`` is the inverse of both: it gives the
optax inner state of the torch optimizer (an SGD buffer torch has not made
yet is zeros, which is exact: optax's first trace step is ``g + 0.9 * 0``,
torch's ``clone(g)``).
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


def _param_buffers(optimizer: torch.optim.Optimizer, modules: Mapping[str, torch.nn.Module],
                   trees: Mapping[str, Mapping], name: str) -> None:
    """Set ``optimizer.state[p][name]`` of every parameter of ``modules``
    from the parameter-shaped JAX ``trees`` (one per module name)."""
    for mod_name, module in modules.items():
        bufs, _ = _param_tensors(trees[mod_name])
        named = dict(module.named_parameters())
        if bufs.keys() != named.keys():
            raise KeyError(f"{mod_name}: optimizer keys {sorted(bufs.keys() ^ named.keys())} "
                           "do not match the module's parameters")
        for key, p in named.items():
            optimizer.state[p][name] = torch.empty_like(p).copy_(bufs[key])


@torch.no_grad()
def opt_state_from_jax(optimizer: torch.optim.Optimizer,
                       modules: Mapping[str, torch.nn.Module],
                       trace: Mapping[str, Mapping]) -> None:
    """Set each parameter's ``momentum_buffer`` in ``optimizer`` (an SGD
    over the parameters of ``modules``) from the optax ``trace`` tree of
    the same names, e.g. ``({"G": g}, {"G": trace_g})`` or
    ``({"F1": f1, "F2": f2, "D": d}, trace_f)``. Raises unless every
    parameter of the modules gets a buffer."""
    _param_buffers(optimizer, modules, trace, "momentum_buffer")


@torch.no_grad()
def adam_state_from_jax(optimizer: torch.optim.Optimizer,
                        modules: Mapping[str, torch.nn.Module],
                        count, mu: Mapping[str, Mapping], nu: Mapping[str, Mapping]) -> None:
    """Set ``torch.optim.Adam``'s state of every parameter of ``modules``
    from ``scale_by_adam``'s state: ``step`` from ``count``, ``exp_avg``
    and ``exp_avg_sq`` from the ``mu`` and ``nu`` trees."""
    _param_buffers(optimizer, modules, mu, "exp_avg")
    _param_buffers(optimizer, modules, nu, "exp_avg_sq")
    step = float(np.asarray(count))
    for module in modules.values():
        for p in module.parameters():
            # torch keeps a non-capturable step on the CPU, in the default dtype
            optimizer.state[p]["step"] = torch.tensor(step)


@torch.no_grad()
def opt_state_to_jax(optimizer: torch.optim.Optimizer,
                     modules: Mapping[str, torch.nn.Module]) -> Dict[str, Any]:
    """The optax inner state of ``optimizer`` over ``modules``, as trees of
    numpy arrays named like the JAX parameters: SGD with momentum gives
    ``{"trace": {...}}``, SGD without ``{}``, Adam ``{"count", "mu",
    "nu"}`` (``count`` int32, 0 before the first update)."""
    def buffer(p, name):
        t = optimizer.state.get(p, {}).get(name)
        return torch.zeros_like(p) if t is None else t

    def tree(name):
        return params_to_jax({mod_name: {k: buffer(p, name) for k, p in m.named_parameters()}
                              for mod_name, m in modules.items()})[0]

    if isinstance(optimizer, torch.optim.Adam):
        steps = {int(s["step"]) for s in optimizer.state.values() if "step" in s} or {0}
        if len(steps) != 1:
            raise ValueError(f"Adam parameters at different steps {sorted(steps)}: "
                             "optax keeps one count")
        return {"count": np.asarray(steps.pop(), np.int32),
                "mu": tree("exp_avg"), "nu": tree("exp_avg_sq")}
    if isinstance(optimizer, torch.optim.SGD):
        momentum = optimizer.param_groups[0]["momentum"]
        return {"trace": tree("momentum_buffer")} if momentum else {}
    raise TypeError(f"no optax state for {type(optimizer).__name__}")
