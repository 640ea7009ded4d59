"""Checkpoints: a torch payload plus the JAX package's config sidecar.

    <prefix>.pt           {step, G, F1, F2 (state dicts), D and B (the
                           multitask trainer's heads, when the state has
                           them), opt_g, opt_f (optimizer state dicts),
                           gen (generator state)}
    <prefix>.config.json  the ExperimentConfig dict, in the layout the JAX
                          package writes beside its msgpack checkpoints

As in the JAX package (``utils/checkpoint.py``), the model is rebuilt from
the config stored beside the weights, and both files are published
atomically (a temporary file, then ``os.replace``), so a prefix always
names a complete checkpoint. A payload with a "D" is a multitask
checkpoint, restored into a state with its auxiliary heads, as the JAX
package detects one. ``prune_epoch_checkpoints`` keeps the newest
``keep_checkpoints`` epoch checkpoints, as the JAX loops do.
``AsyncCheckpointer`` copies the state to host memory on the caller's
thread and writes it on a background thread.

JAX checkpoints, both ways. ``save_jax_checkpoint`` writes the JAX
package's own layout (``mcseg_tpu/utils/checkpoint.py``):

    <prefix>.msgpack      {step, params{G,F1,F2[,D][,B]}, batch_stats{G,F1,F2},
                           opt_g, opt_f, rng} in flax's msgpack
                           (``utils/msgpack_compat.py``, no msgpack package)
    <prefix>.config.json  the same sidecar as above

and ``load_jax_checkpoint`` reads it into a train state; ``load_params``
and ``load_checkpoint`` read ``<prefix>.msgpack`` when ``<prefix>.pt`` is
absent, so the tester, the serving export and ``--resume`` take a JAX
checkpoint as it is. Weights and BN statistics go through
``utils/jax_weights.py``; each optax state is ``inject_hyperparams`` over
``chain(decay, trace | scale_by_adam, scale_by_learning_rate)``, whose
trace (SGD momentum) or ``{count, mu, nu}`` (Adam) comes from the torch
optimizer. The values torch does not keep are derived from ``step`` and
the config:

  * ``count`` (optax's update counter): ``step`` times the updates one
    iteration makes, ``1 + num_k`` over G and 2 over the heads under
    ``method`` "MCD" (steps A and C x num_k; A and B), 1 and 1 otherwise;
  * ``hyperparams.learning_rate``: the rate of the last iteration,
    ``schedule(step - 1)``, or ``lr`` at step 0, in float32 (float64 for a
    float64 state); each step overwrites it before use;
  * ``rng``: the key the JAX loop holds after ``step`` iterations.
    JAX seeds ``key(seed)``, splits it (``create_train_state`` keeps the
    second of 2 keys, ``init_multitask_state`` the fourth of 4) and each
    step keeps the first key of its split. Under JAX's
    ``jax_threefry_partitionable`` (the default since JAX 0.5) the i-th
    key of a split is ``threefry2x32(key, (0, i))`` whatever the width,
    which ``_threefry2x32`` computes.

Read the other way, those three are dropped: the port's state keeps
``step``, and its generator is the one ``create_train_state`` seeds from
the config (the port draws nothing from it after the initial weights).
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.models.factory import AUX_HEADS, Params
from mcseg_tpu_torch.train.optim import make_lr_schedule
from mcseg_tpu_torch.train.state import MCDTrainState, create_train_state
from mcseg_tpu_torch.utils import msgpack_compat
from mcseg_tpu_torch.utils.jax_weights import (
    adam_state_from_jax, opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax)


def _publish(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _payload(state: MCDTrainState) -> dict:
    """The checkpoint's tensors and step, by reference to the live state."""
    return {
        "step": state.step,
        **state.params(),
        "opt_g": state.opt_g.state_dict(),
        "opt_f": state.opt_f.state_dict(),
        "gen": state.gen.get_state(),
    }


def _write(prefix: str, payload: dict, config_dict: dict, suffix: str = ".pt",
           dump: Callable[[dict, str], object] = torch.save) -> str:
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    path = prefix + suffix
    _publish(path, lambda p: dump(payload, p))

    def write_config(p):
        with open(p, "w") as f:
            json.dump(config_dict, f, indent=2, sort_keys=True, default=str)

    _publish(prefix + ".config.json", write_config)
    return path


def save_checkpoint(prefix: str, state: MCDTrainState, config: ExperimentConfig) -> str:
    """Write <prefix>.pt and <prefix>.config.json; returns the .pt path."""
    return _write(prefix, _payload(state), config.to_dict())


def _host_copy(obj):
    """``obj`` with every tensor replaced by a copy in host memory: the
    optimizers update the parameters in place, so a reference would let
    the next step reach a checkpoint still being written."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class AsyncCheckpointer:
    """Checkpoint writes that overlap training.

    ``save`` copies the state to host memory on the caller's thread (the
    only part that waits for the device) and hands serialization and the
    atomic file writes to one writer thread. Writes publish in submission
    order; at most one copy waits while one is written, so a slow disk
    holds the loop back instead of growing memory. A failure of the writer
    is raised again, as RuntimeError, by the next ``save`` or by ``join``.
    ``after`` runs on the writer thread once its checkpoint has published
    (epoch pruning then sees the file it accompanies)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="mcseg-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            job = self._q.get()
            try:
                if job is None:
                    return
                prefix, payload, config_dict, after = job
                _write(prefix, payload, config_dict)
                if after is not None:
                    after()
            except Exception as e:  # raised again by the next save()/join()
                with self._lock:
                    self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        with self._lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, prefix: str, state: MCDTrainState, config: ExperimentConfig,
             after: Optional[Callable[[], object]] = None) -> None:
        """Copy the state to host memory now; write it in the background."""
        self._raise_pending()
        self._q.put((prefix, _host_copy(_payload(state)), config.to_dict(), after))

    def join(self) -> None:
        """Wait until every accepted write has published; raise a writer
        failure."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        self.join()
        self._q.put(None)
        self._thread.join()


def prune_epoch_checkpoints(out_dir: str, keep: int) -> List[str]:
    """Delete all but the newest ``keep`` epoch checkpoints (``ep<N>.pt``
    and their config sidecars) in ``out_dir``; ``last`` is never touched
    and ``keep <= 0`` keeps everything. Returns the pruned prefixes."""
    if keep <= 0:
        return []
    eps = []
    for p in glob.glob(os.path.join(out_dir, "ep*.pt")):
        m = re.fullmatch(r"ep(\d+)\.pt", os.path.basename(p))
        if m:
            eps.append((int(m.group(1)), p[: -len(".pt")]))
    eps.sort()
    pruned = []
    for _, prefix in eps[:-keep]:
        for suffix in (".pt", ".config.json"):
            try:
                os.remove(prefix + suffix)
            except FileNotFoundError:
                pass
        pruned.append(prefix)
    return pruned


def load_config(prefix: str) -> ExperimentConfig:
    with open(prefix + ".config.json") as f:
        return ExperimentConfig.from_dict(json.load(f))


def _params(payload) -> Params:
    return {k: payload[k] for k in ("G", "F1", "F2", *AUX_HEADS) if k in payload}


def _is_jax(prefix: str) -> bool:
    """Only a JAX ``<prefix>.msgpack`` is there (a ``.pt`` wins)."""
    return not os.path.exists(prefix + ".pt") and os.path.exists(prefix + ".msgpack")


def load_params(prefix: str) -> Tuple[Params, ExperimentConfig]:
    """(``{"G", "F1", "F2"[, "D"][, "B"]}`` CPU state dicts, config) —
    what ``eval.tester.evaluate`` scores — from ``<prefix>.pt`` or, where
    there is none, the JAX ``<prefix>.msgpack``."""
    if _is_jax(prefix):
        raw = _read_jax(prefix)
        return params_from_jax(raw["params"], raw["batch_stats"]), load_config(prefix)
    payload = torch.load(prefix + ".pt", map_location="cpu", weights_only=True)
    return _params(payload), load_config(prefix)


def load_checkpoint(prefix: str, device="cuda",
                    config: Optional[ExperimentConfig] = None
                    ) -> Tuple[MCDTrainState, ExperimentConfig]:
    """Rebuild the train state (weights and auxiliary heads, both
    optimizers, step, generator) on ``device`` from the checkpoint's own
    config unless ``config`` is given; from ``<prefix>.pt`` or, where
    there is none, the JAX ``<prefix>.msgpack``."""
    if _is_jax(prefix):
        return load_jax_checkpoint(prefix, device, config)
    config = config or load_config(prefix)
    payload = torch.load(prefix + ".pt", map_location="cpu", weights_only=True)
    params = _params(payload)
    state = create_train_state(config.model, config.train, config.train.seed,
                               device, params=params,
                               aux_heads=[k for k in AUX_HEADS if k in params])
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_f.load_state_dict(payload["opt_f"])
    state.step = int(payload["step"])
    state.gen.set_state(payload["gen"])
    return state, config


# ---- JAX checkpoints -------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: Tuple[int, int], count: Tuple[int, int]) -> Tuple[int, int]:
    """JAX's threefry2x32 hash (20 rounds) of one counter pair."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (count[0] + ks[0]) & _MASK32, (count[1] + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def jax_rng(config: ExperimentConfig, step: int, multitask: bool) -> np.ndarray:
    """The key data (uint32[2]) of the JAX loop's rng after ``step``
    iterations (module docstring)."""
    seed = int(config.train.seed)
    key = ((seed >> 32) & _MASK32, seed & _MASK32)
    key = _threefry2x32(key, (0, 3 if multitask else 1))
    for _ in range(int(step)):
        key = _threefry2x32(key, (0, 0))
    return np.asarray(key, np.uint32)


def _updates_per_iteration(config: ExperimentConfig) -> Tuple[int, int]:
    """Optimizer updates of one iteration over (G, the heads)."""
    return (1 + config.train.num_k, 2) if config.model.method == "MCD" else (1, 1)


def _trees(inner: dict, wrap) -> dict:
    """``inner`` with each tree (all but ``count``) passed through ``wrap``:
    optax's G state is over G's tree, the port's over ``{"G": G}``."""
    return {k: v if k == "count" else wrap(v) for k, v in inner.items()}


def _optax_state(optimizer: torch.optim.Optimizer, modules, count: int, lr: float,
                 lr_dtype) -> dict:
    """``inject_hyperparams(chain(...))``'s state dict for ``optimizer``."""
    inner = opt_state_to_jax(optimizer, modules)
    if list(modules) == ["G"]:
        inner = _trees(inner, lambda t: t["G"])
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"learning_rate": np.asarray(lr, lr_dtype)},
            "hyperparams_states": {},
            "inner_state": {"0": {}, "1": inner, "2": {}}}


def _jax_payload(state: MCDTrainState, config: ExperimentConfig) -> dict:
    params, stats = params_to_jax(state.params())
    stats = {k: v for k, v in stats.items() if k in ("G", "F1", "F2")}
    t = config.train
    lr = make_lr_schedule(t.lr_schedule, t.lr, t.max_steps, t.lr_power)(state.step - 1) \
        if state.step > 0 else t.lr
    lr_dtype = np.float64 if next(state.g.parameters()).dtype == torch.float64 else np.float32
    per_g, per_f = _updates_per_iteration(config)
    heads = {k: m for k, m in state.modules().items() if k != "G"}
    return {
        "step": np.asarray(state.step, np.int32),
        "params": params,
        "batch_stats": stats,
        "opt_g": _optax_state(state.opt_g, {"G": state.g}, per_g * state.step, lr, lr_dtype),
        "opt_f": _optax_state(state.opt_f, heads, per_f * state.step, lr, lr_dtype),
        "rng": jax_rng(config, state.step, multitask="D" in params),
    }


def _dump_msgpack(payload: dict, path: str) -> None:
    with open(path, "wb") as f:
        f.write(msgpack_compat.serialize(payload))


def save_jax_checkpoint(prefix: str, state: MCDTrainState, config: ExperimentConfig) -> str:
    """Write the JAX package's ``<prefix>.msgpack`` and
    ``<prefix>.config.json`` of ``state``; returns the msgpack path."""
    return _write(prefix, _jax_payload(state, config), config.to_dict(), ".msgpack",
                  _dump_msgpack)


def _read_jax(prefix: str) -> dict:
    with open(prefix + ".msgpack", "rb") as f:
        return msgpack_compat.restore(f.read())


def _opt_from_jax(optimizer: torch.optim.Optimizer, modules, opt_state: dict) -> None:
    inner = opt_state["inner_state"]["1"]
    if list(modules) == ["G"]:
        inner = _trees(inner, lambda t: {"G": t})
    if isinstance(optimizer, torch.optim.Adam) and set(inner) == {"count", "mu", "nu"}:
        adam_state_from_jax(optimizer, modules, inner["count"], inner["mu"], inner["nu"])
    elif isinstance(optimizer, torch.optim.SGD) and set(inner) == {"trace"}:
        opt_state_from_jax(optimizer, modules, inner["trace"])
    elif not (isinstance(optimizer, torch.optim.SGD) and not inner
              and not optimizer.param_groups[0]["momentum"]):
        raise ValueError(f"the checkpoint's optimizer state {sorted(inner)} does not fit "
                         f"the config's {type(optimizer).__name__}")


def load_jax_checkpoint(prefix: str, device="cuda",
                        config: Optional[ExperimentConfig] = None
                        ) -> Tuple[MCDTrainState, ExperimentConfig]:
    """The train state of a JAX ``<prefix>.msgpack`` on ``device``: weights
    and auxiliary heads, BN statistics, both optimizers and the step,
    built from the checkpoint's own config unless ``config`` is given."""
    config = config or load_config(prefix)
    raw = _read_jax(prefix)
    params = params_from_jax(raw["params"], raw["batch_stats"])
    state = create_train_state(config.model, config.train, config.train.seed, device,
                               params=params, aux_heads=[k for k in AUX_HEADS if k in params])
    _opt_from_jax(state.opt_g, {"G": state.g}, raw["opt_g"])
    _opt_from_jax(state.opt_f, {k: m for k, m in state.modules().items() if k != "G"},
                  raw["opt_f"])
    state.step = int(np.asarray(raw["step"]))
    return state, config
