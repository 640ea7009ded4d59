"""NYU40-family label space: remap table, class names, palette.

The port's own copy of what the serving slice needs from the JAX package's
``data/labels.py``. Cityscapes/GTA5/SYNTHIA tables come with the real-corpus
readers.
"""

from __future__ import annotations

import numpy as np

IGNORE = 255

NYU40_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor_mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower_curtain", "box", "whiteboard", "person", "night_stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
)


def nyu40_raw_to_train_table() -> np.ndarray:
    """[256] uint8 lookup: raw NYU40/SUNCG label (0=void, 1..40) -> 0..39 / 255."""
    table = np.full(256, IGNORE, dtype=np.uint8)
    for raw in range(1, 41):
        table[raw] = raw - 1
    return table


def voc_style_palette(n: int) -> np.ndarray:
    """Deterministic class->RGB palette via the PASCAL-VOC bit-shuffle."""
    pal = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        lab, r = i, np.zeros(3, np.uint16)
        for j in range(8):
            r[0] |= ((lab >> 0) & 1) << (7 - j)
            r[1] |= ((lab >> 1) & 1) << (7 - j)
            r[2] |= ((lab >> 2) & 1) << (7 - j)
            lab >>= 3
        pal[i] = r.astype(np.uint8)
    return pal


NYU40_PALETTE = voc_style_palette(40)

_NYU_FAMILY = ("nyu", "nyudv2", "suncg", "synthetic", "synthetic_shifted")


def get_label_spec(dataset: str):
    """(n_class, remap_table, names, palette) per corpus."""
    if dataset.lower() in _NYU_FAMILY:
        return 40, nyu40_raw_to_train_table(), NYU40_NAMES, NYU40_PALETTE
    raise ValueError(
        f"unknown dataset {dataset!r}; the port knows {sorted(_NYU_FAMILY)}")
