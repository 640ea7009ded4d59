"""Label spaces: remap tables, class names, palettes.

The port's own copy of the JAX package's ``data/labels.py``. Two label
spaces: Cityscapes' 19 train classes (Cityscapes, GTA5, IR and, through
its own table, SYNTHIA) and NYUDv2-40 (NYUDv2, SUNCG and the synthetic
corpora; raw 0 = void -> 255, 1..40 -> 0..39). Remaps are dense [256]
lookup tables, applied as one gather.
"""

from __future__ import annotations

import numpy as np

IGNORE = 255

CITYSCAPES_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "light", "sign",
    "vegetation", "terrain", "sky", "person", "rider", "car", "truck", "bus",
    "train", "motocycle", "bicycle",
)

# full id -> train id (the Cityscapes toolkit's labels.py)
_CITY_ID_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

CITYSCAPES_PALETTE = np.array(
    [
        (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
        (0, 0, 230), (119, 11, 32),
    ],
    dtype=np.uint8,
)

# SYNTHIA-RAND-CITYSCAPES ids -> Cityscapes train ids (the 16-class UDA
# subset; terrain, truck and train have no SYNTHIA counterpart)
_SYNTHIA_TO_CITY_TRAIN = {
    1: 10, 2: 2, 3: 0, 4: 1, 5: 4, 6: 8, 7: 5, 8: 13, 9: 7, 10: 11,
    11: 18, 12: 17, 15: 6, 17: 12, 19: 15, 21: 3,
}

NYU40_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "blinds", "desk", "shelves",
    "curtain", "dresser", "pillow", "mirror", "floor_mat", "clothes",
    "ceiling", "books", "refridgerator", "television", "paper", "towel",
    "shower_curtain", "box", "whiteboard", "person", "night_stand", "toilet",
    "sink", "lamp", "bathtub", "bag", "otherstructure", "otherfurniture",
    "otherprop",
)


def _table(mapping) -> np.ndarray:
    table = np.full(256, IGNORE, dtype=np.uint8)
    for k, v in mapping.items():
        table[k] = v
    return table


def cityscapes_id_to_train_table() -> np.ndarray:
    """[256] uint8 lookup: raw Cityscapes/GTA5 label id -> train id or 255."""
    return _table(_CITY_ID_TO_TRAIN)


def synthia_to_train_table() -> np.ndarray:
    """[256] uint8 lookup: raw SYNTHIA id -> Cityscapes train id or 255."""
    return _table(_SYNTHIA_TO_CITY_TRAIN)


def nyu40_raw_to_train_table() -> np.ndarray:
    """[256] uint8 lookup: raw NYU40/SUNCG label (0=void, 1..40) -> 0..39 / 255."""
    return _table({raw: raw - 1 for raw in range(1, 41)})


def cityscapes_train_to_id_table() -> np.ndarray:
    """[256] uint8 lookup: train id -> full Cityscapes label id, the inverse
    of ``cityscapes_id_to_train_table``; everything else -> 0
    ("unlabeled"). The evaluation server scores labelId PNGs."""
    table = np.zeros(256, dtype=np.uint8)
    for k, v in _CITY_ID_TO_TRAIN.items():
        table[v] = k
    return table


def get_submit_table(dataset: str):
    """Prediction remap of the submission dumps (``--submit_dir``), or None
    for a corpus without an evaluation server (all but Cityscapes)."""
    if dataset.lower() in ("city", "cityscapes"):
        return cityscapes_train_to_id_table()
    return None


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


def get_label_spec(dataset: str):
    """(n_class, remap_table, names, palette) per corpus."""
    d = dataset.lower()
    if d == "synthia":
        return 19, synthia_to_train_table(), CITYSCAPES_NAMES, CITYSCAPES_PALETTE
    if d in ("city", "cityscapes", "gta", "gta5", "ir"):
        return 19, cityscapes_id_to_train_table(), CITYSCAPES_NAMES, CITYSCAPES_PALETTE
    if d in ("nyu", "nyudv2", "suncg", "synthetic", "synthetic_shifted"):
        return 40, nyu40_raw_to_train_table(), NYU40_NAMES, NYU40_PALETTE
    raise ValueError(f"unknown dataset {dataset!r}")
