"""Frozen config dataclasses — the port's own copy of the JAX package's
``core/config.py``.

Same classes, field names, defaults and ``to_dict``/``from_dict`` round-trip,
so the port reads the ``*.config.json`` sidecars that the JAX checkpoints
carry, unchanged. Some fields select JAX-only behaviour (``s2d``, the
decode caches, ``device_corpus``); the port keeps them so a sidecar
round-trips, and ignores them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


def _asdict(cfg) -> Dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["__class__"] = type(cfg).__name__
    return d


@dataclass(frozen=True)
class ModelConfig:
    """Model zoo selection (the reference's ``get_models(...)`` surface)."""

    net: str = "drn_d_38"  # drn_d_14|22|38|54|105, drn_c_26|42, fcn8s_vgg16, psp
    input_ch: int = 3  # 1 depth | 3 rgb | 4 rgb+d | 6 rgb+hha | 7 rgb+hha+boundary
    n_class: int = 40
    method: str = "MCD"  # MCD (G,F1,F2) | source-only (G,F1)
    fusion: str = "single"  # 'single' | 'early' | 'late'
    uses_one_classifier: bool = False
    # activation dtype: bf16 on the card, params and BN stats stay fp32
    dtype: str = "bfloat16"
    # pixel-classifier upsampling: 'convt' = fixed-bilinear ConvTranspose2d
    # (fill_up_weights) | 'resize' = half-pixel bilinear
    upsample: str = "convt"
    s2d: str = "auto"  # JAX-only layout option; read and ignored by the port

    def to_dict(self):
        return _asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ModelConfig":
        d = {k: v for k, v in d.items() if k != "__class__"}
        if "train_img_shape" in d:
            d["train_img_shape"] = tuple(d["train_img_shape"])
        return ModelConfig(**d)


@dataclass(frozen=True)
class DataConfig:
    """Dataset + preprocessing selection."""

    src_dataset: str = "suncg"
    tgt_dataset: str = "nyu"
    split: str = "train"
    data_root: str = "./data"
    batch_size: int = 8
    train_img_shape: Tuple[int, int] = (640, 480)  # (W, H) — reference flag order
    test_img_shape: Tuple[int, int] = (640, 480)
    input_ch: int = 3
    n_class: int = 40
    num_workers: int = 4
    random_flip: bool = True
    random_crop: bool = True
    crop_scale_min: float = 0.7
    # encode HHA on the device from raw depth vs load precomputed HHA planes
    hha_on_device: bool = True
    max_samples: Optional[int] = None
    decode_cache_gb: float = 4.0
    decode_disk_cache_gb: float = 0.0
    decode_disk_cache_dir: str = ""
    device_corpus: str = "auto"
    device_corpus_gb: float = 4.0
    # appearance-shift strength of the 'synthetic_shifted' corpus
    domain_shift: float = 1.0

    def to_dict(self):
        return _asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataConfig":
        d = {k: v for k, v in d.items() if k != "__class__"}
        for k in ("train_img_shape", "test_img_shape"):
            if k in d:
                d[k] = tuple(d[k])
        return DataConfig(**d)


@dataclass(frozen=True)
class TrainConfig:
    """Optimization + MCD hyperparameters."""

    opt: str = "sgd"
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 2e-5
    epochs: int = 20
    num_k: int = 4
    d_loss: str = "diff"
    lr_schedule: str = "poly"
    lr_power: float = 0.9
    max_steps: int = 50_000
    seed: int = 0
    resume: str = ""
    out_dir: str = "./runs"
    log_every: int = 50
    tb_dir: str = ""
    checkpoint_every_epochs: int = 1
    max_hours: float = 0.0
    keep_checkpoints: int = 0
    spatial_devices: int = 1
    async_checkpoint: bool = True

    def to_dict(self):
        return _asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainConfig":
        d = {k: v for k, v in d.items() if k != "__class__"}
        return TrainConfig(**d)


@dataclass(frozen=True)
class ExperimentConfig:
    """Bundle persisted beside every checkpoint."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self):
        return {
            "model": self.model.to_dict(),
            "data": self.data.to_dict(),
            "train": self.train.to_dict(),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        return ExperimentConfig(
            model=ModelConfig.from_dict(d["model"]),
            data=DataConfig.from_dict(d["data"]),
            train=TrainConfig.from_dict(d["train"]),
        )
