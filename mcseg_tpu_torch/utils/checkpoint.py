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
``keep_checkpoints`` epoch checkpoints, as the JAX loops do. Conversion to
and from the JAX msgpack payload comes in a later slice.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Optional, Tuple

import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.models.factory import AUX_HEADS, Params
from mcseg_tpu_torch.train.state import MCDTrainState, create_train_state


def _publish(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(prefix: str, state: MCDTrainState, config: ExperimentConfig) -> str:
    """Write <prefix>.pt and <prefix>.config.json; returns the .pt path."""
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    payload = {
        "step": state.step,
        **state.params(),
        "opt_g": state.opt_g.state_dict(),
        "opt_f": state.opt_f.state_dict(),
        "gen": state.gen.get_state(),
    }
    path = prefix + ".pt"
    _publish(path, lambda p: torch.save(payload, p))

    def write_config(p):
        with open(p, "w") as f:
            json.dump(config.to_dict(), f, indent=2, sort_keys=True, default=str)

    _publish(prefix + ".config.json", write_config)
    return path


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
