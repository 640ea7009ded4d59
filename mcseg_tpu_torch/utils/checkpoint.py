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
thread and writes it on a background thread. Conversion to and from the
JAX msgpack payload comes in a later slice.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import re
import threading
from typing import Callable, List, Optional, Tuple

import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.models.factory import AUX_HEADS, Params
from mcseg_tpu_torch.train.state import MCDTrainState, create_train_state


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


def _write(prefix: str, payload: dict, config_dict: dict) -> str:
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    path = prefix + ".pt"
    _publish(path, lambda p: torch.save(payload, p))

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


def load_params(prefix: str) -> Tuple[Params, ExperimentConfig]:
    """(``{"G", "F1", "F2"[, "D"][, "B"]}`` CPU state dicts, config) —
    what ``eval.tester.evaluate`` scores."""
    payload = torch.load(prefix + ".pt", map_location="cpu", weights_only=True)
    return _params(payload), load_config(prefix)


def load_checkpoint(prefix: str, device="cuda",
                    config: Optional[ExperimentConfig] = None
                    ) -> Tuple[MCDTrainState, ExperimentConfig]:
    """Rebuild the train state (weights and auxiliary heads, both
    optimizers, step, generator) on ``device`` from the checkpoint's own
    config unless ``config`` is given."""
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
