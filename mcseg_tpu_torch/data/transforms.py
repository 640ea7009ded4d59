"""Normalization constants (torchvision's ImageNet statistics) and the
prediction dumps (label PNGs and their colour renderings).

HHA is encoded into an image-like [0, 255] range and normalized with the
RGB constants, as in the reference. ``encode_png`` writes 8-bit RGB, 8-bit
gray and 16-bit gray PNGs with the standard library alone (zlib, filter
type 0), so neither the dumps nor the corpus tools need an image library.
"""

import struct
import zlib

import numpy as np

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
HHA_MEAN = RGB_MEAN
HHA_STD = RGB_STD

# PNG colour types of the IHDR chunk
_GRAY, _RGB = 0, 2


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of uint8 [H,W] (gray), uint8 [H,W,3] (RGB) or uint16
    [H,W] (16-bit gray, stored big-endian); non-interlaced, every row
    unfiltered."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint8 and arr.ndim == 2:
        depth, color, rows = 8, _GRAY, arr
    elif arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3:
        depth, color, rows = 8, _RGB, arr.reshape(arr.shape[0], -1)
    elif arr.dtype == np.uint16 and arr.ndim == 2:
        depth, color, rows = 16, _GRAY, arr.astype(">u2").view(np.uint8)
    else:
        raise ValueError(f"encode_png takes uint8 [H,W] or [H,W,3] or uint16 [H,W], "
                         f"got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter byte 0
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(raw).tobytes(), level))
            + _chunk(b"IEND", b""))


def save_png(arr: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(arr))


def save_label_png(label: np.ndarray, path: str) -> None:
    """A label map as an 8-bit gray PNG."""
    save_png(np.asarray(label).astype(np.uint8), path)


def colorize(label: np.ndarray, palette: np.ndarray, ignore: int = 255) -> np.ndarray:
    """Class-id map -> RGB uint8 through ``palette``; ``ignore`` -> black,
    other ids clipped to the palette (the reference's ``Colorize``)."""
    label = np.asarray(label)
    out = np.zeros((*label.shape, 3), np.uint8)
    valid = label != ignore
    clipped = np.clip(label, 0, len(palette) - 1)
    out[valid] = np.asarray(palette)[clipped[valid]]
    return out


def save_color_png(label: np.ndarray, palette: np.ndarray, path: str) -> None:
    """A label map as an RGB PNG in the corpus's colours."""
    save_png(colorize(label, palette), path)
