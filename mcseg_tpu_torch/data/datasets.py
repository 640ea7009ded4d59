"""Procedural RGB-D corpora (no disk): ``synthetic`` and its appearance-
shifted target twin ``synthetic_shifted``.

Pure numpy, deterministic per (seed, split, index), and sample-for-sample
identical to the JAX package's readers of the same names. Samples are raw
decoded planes at the decode size: uint8 RGB [H,W,3], uint8 raw label
[H,W], float32 depth in metres [H,W]. Real corpora come in a later slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.labels import get_label_spec


class SyntheticDataset:
    """Depth-stacked rectangles over a floor plane; class identity sets both
    colour (plus noise) and depth, so RGB-D segmentation is learnable."""

    corpus = "synthetic"
    decode_size = (640, 480)  # (W, H)
    has_depth = True
    length = 64  # samples per split unless cfg.max_samples says otherwise

    def __init__(self, cfg: DataConfig, split: str = "train", seed: int = 0):
        self.cfg = cfg
        self.split = split
        self.length = cfg.max_samples or self.length
        self.n_class, self.remap_table, self.names, self.palette = get_label_spec("nyu")
        self.seed = seed + (0 if split == "train" else 10_000)
        if cfg.test_img_shape and split != "train":
            self.decode_size = tuple(cfg.test_img_shape)
        elif cfg.train_img_shape:
            self.decode_size = tuple(cfg.train_img_shape)

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 100_003 + i)
        w, h = self.decode_size
        n_cls = min(self.n_class, 12)
        label_raw = np.ones((h, w), np.uint8)  # raw class 1 = background/floor
        depth = np.full((h, w), 4.0, np.float32)
        depth += np.linspace(1.0, -1.5, h)[:, None]  # floor: nearer at the bottom
        for _ in range(rng.randint(4, 9)):
            cls = rng.randint(1, n_cls + 1)
            bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
            x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            z = rng.uniform(0.8, 3.5)
            region = depth[y0 : y0 + bh, x0 : x0 + bw]
            mask = region > z  # only paint where the box is nearer
            region[mask] = z
            label_raw[y0 : y0 + bh, x0 : x0 + bw][mask] = cls
        base = (np.arange(1, n_cls + 2)[:, None] * np.array([[53, 101, 197]])) % 255
        base, noise_std = self._appearance(base.astype(np.float64))
        img = base[label_raw].astype(np.float32)
        img += rng.randn(h, w, 3) * noise_std
        img = np.clip(img, 0, 255).astype(np.uint8)
        void = rng.rand(h, w) < 0.01  # a few void pixels
        label_raw[void] = 0
        return {"image": img, "label": label_raw, "depth": depth}

    def _appearance(self, base: np.ndarray):
        """(class->colour table, noise std) hook for domain-shift variants."""
        return base, 12.0


class SyntheticShiftedDataset(SyntheticDataset):
    """Target-domain twin under a deterministic appearance shift of strength
    ``DataConfig.domain_shift`` (s): each class colour blends toward its
    neighbour's (a = min(0.4 s, 0.45)), per-channel gain
    (1+0.2s, 1-0.15s, 1+0.1s) plus a 14 s bias, noise std 12 -> 12 + 4 s.
    Geometry, depth and the label distribution are those of ``synthetic``."""

    corpus = "synthetic_shifted"

    def __init__(self, cfg: DataConfig, split: str = "train", seed: int = 0):
        super().__init__(cfg, split, seed=seed + 7)
        self.shift = float(getattr(cfg, "domain_shift", 1.0))

    def _appearance(self, base: np.ndarray):
        s = self.shift
        if s <= 0.0:
            return base, 12.0
        a = min(0.40 * s, 0.45)
        base = (1.0 - a) * base + a * np.roll(base, 1, axis=0)
        gain = np.array([1.0 + 0.20 * s, 1.0 - 0.15 * s, 1.0 + 0.10 * s])
        base = np.clip(base * gain + 14.0 * s, 0.0, 255.0)
        return base, 12.0 + 4.0 * s


_CORPORA = {
    "synthetic": SyntheticDataset,
    "synthetic_shifted": SyntheticShiftedDataset,
}


def get_dataset(name: str, cfg: DataConfig, split: str = "train"):
    """Reader factory; the port knows the procedural corpora so far."""
    key = name.lower()
    if key not in _CORPORA:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(_CORPORA)}")
    return _CORPORA[key](cfg, split)


class ZipDataset:
    """A source and a target dataset paired sample by sample, ``len`` the
    shorter of the two (the reference's zipped source/target loader)."""

    def __init__(self, source, target):
        self.source = source
        self.target = target

    def __len__(self) -> int:
        return min(len(self.source), len(self.target))

    def __getitem__(self, i: int):
        return self.source[i], self.target[i]


def stack_samples(dataset, indices) -> Dict[str, np.ndarray]:
    """Stack the samples at ``indices`` into [N, ...] batch arrays."""
    samples = [dataset[i] for i in indices]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
