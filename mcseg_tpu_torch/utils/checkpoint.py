"""Checkpoints: a torch payload plus the JAX package's config sidecar.

    <prefix>.pt           {step, G, F1, F2 (state dicts), opt_g, opt_f
                           (optimizer state dicts), gen (generator state)}
    <prefix>.config.json  the ExperimentConfig dict, in the layout the JAX
                          package writes beside its msgpack checkpoints

As in the JAX package (``utils/checkpoint.py``), the model is rebuilt from
the config stored beside the weights, and both files are published
atomically (a temporary file, then ``os.replace``), so a prefix always
names a complete checkpoint. Conversion to and from the JAX msgpack
payload comes in a later slice.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.models.factory import Params
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


def load_config(prefix: str) -> ExperimentConfig:
    with open(prefix + ".config.json") as f:
        return ExperimentConfig.from_dict(json.load(f))


def load_params(prefix: str) -> Tuple[Params, ExperimentConfig]:
    """(``{"G", "F1", "F2"}`` CPU state dicts, config) — what
    ``eval.tester.evaluate`` scores."""
    payload = torch.load(prefix + ".pt", map_location="cpu", weights_only=True)
    return {k: payload[k] for k in ("G", "F1", "F2")}, load_config(prefix)


def load_checkpoint(prefix: str, device="cuda",
                    config: Optional[ExperimentConfig] = None
                    ) -> Tuple[MCDTrainState, ExperimentConfig]:
    """Rebuild the train state (weights, both optimizers, step, generator)
    on ``device`` from the checkpoint's own config unless ``config`` is
    given."""
    config = config or load_config(prefix)
    payload = torch.load(prefix + ".pt", map_location="cpu", weights_only=True)
    params = {k: payload[k] for k in ("G", "F1", "F2")}
    state = create_train_state(config.model, config.train, config.train.seed,
                               device, params=params)
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_f.load_state_dict(payload["opt_f"])
    state.step = int(payload["step"])
    state.gen.set_state(payload["gen"])
    return state, config
