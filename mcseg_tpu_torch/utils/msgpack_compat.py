"""The msgpack subset that flax checkpoints use, without the ``msgpack``
package.

``flax.serialization.to_bytes`` writes a state dict: maps with str keys
whose leaves are arrays, numpy scalars, ints, floats, strs, bytes, bools
and None. Arrays travel as msgpack ext type 1 and numpy scalars as ext
type 3; either payload is itself msgpack, the array ``(shape, dtype name,
C-order bytes)``. An array above ``MAX_CHUNK_SIZE`` bytes becomes flax's
chunked map ``{"__msgpack_chunked_array__": True, "shape": {...},
"chunks": {...}}``, which ``restore`` joins again and ``serialize`` makes.

``serialize`` gives the bytes ``flax.serialization.msgpack_serialize``
gives for the same tree (the smallest encoding of each value, in
msgpack-python's choice of formats); ``restore`` reads what
``msgpack_restore`` reads. numpy has no bfloat16, so a bfloat16 array or
scalar decodes to a torch tensor of that dtype (0-d for a scalar), and a
bfloat16 torch tensor encodes under flax's dtype name "bfloat16"; every
other array is numpy.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3  # flax's _MsgpackExtType
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_TORCH_ONLY = {"bfloat16": torch.bfloat16}


class _Writer:
    def __init__(self):
        self.parts = []

    def head(self, small_tag: int, small_max: int, tags, n: int) -> None:
        """A length header: the fix form below ``small_max`` (when
        ``small_tag`` is set), else the first of ``tags`` (8/16/32-bit
        lengths, None where msgpack has no such form) that holds ``n``."""
        if small_tag is not None and n < small_max:
            self.parts.append(bytes([small_tag | n]))
            return
        for tag, fmt in zip(tags, (">B", ">H", ">I")):
            if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
                self.parts.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack cannot hold a length of {n}")

    def int(self, n: int) -> None:
        if 0 <= n < 128 or -32 <= n < 0:
            self.parts.append(struct.pack(">b" if n < 0 else ">B", n))
            return
        forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if n >= 0 else \
            ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
        for tag, fmt in forms:
            bits = 8 * struct.calcsize(fmt)
            if (n < 1 << bits) if n >= 0 else (n >= -(1 << (bits - 1))):
                self.parts.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"msgpack cannot hold the integer {n}")

    def value(self, obj: Any) -> None:
        if obj is None:
            self.parts.append(b"\xc0")
        elif isinstance(obj, (np.ndarray, torch.Tensor)):
            self.ext(EXT_NDARRAY, _array_payload(obj))
        elif isinstance(obj, np.generic):
            self.ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)))
        elif isinstance(obj, bool):
            self.parts.append(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, int):
            self.int(obj)
        elif isinstance(obj, float):
            self.parts.append(b"\xcb" + struct.pack(">d", obj))
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            self.head(0xA0, 32, (0xD9, 0xDA, 0xDB), len(data))
            self.parts.append(data)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            data = bytes(obj)
            self.head(None, 0, (0xC4, 0xC5, 0xC6), len(data))
            self.parts.append(data)
        elif isinstance(obj, (list, tuple)):
            self.head(0x90, 16, (None, 0xDC, 0xDD), len(obj))
            for v in obj:
                self.value(v)
        elif isinstance(obj, dict):
            self.head(0x80, 16, (None, 0xDE, 0xDF), len(obj))
            for k, v in obj.items():
                self.value(k)
                self.value(v)
        else:
            raise TypeError(f"no msgpack encoding for {type(obj).__name__}")

    def ext(self, code: int, data: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            self.parts.append(bytes([fixed[len(data)]]))
        else:
            self.head(None, 0, (0xC7, 0xC8, 0xC9), len(data))
        self.parts.append(struct.pack(">b", code) + data)


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (no chunking)."""
    w = _Writer()
    w.value(obj)
    return b"".join(w.parts)


def _array_payload(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        names = {v: k for k, v in _TORCH_ONLY.items()}
        if t.dtype in names:
            raw = t.view(torch.int16).numpy().tobytes()
            return packb([list(t.shape), names[t.dtype], raw])
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax encoding")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _array_from_payload(data: bytes):
    shape, name, raw = unpackb(data, raw=True)
    name = name.decode("ascii")
    buf = bytearray(raw)  # writable, so torch.from_numpy takes it without a copy
    if name in _TORCH_ONLY:
        dtype = _TORCH_ONLY[name]
        return (torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_payload(data)
        if code == EXT_NPSCALAR:
            arr = _array_from_payload(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        raise ValueError(f"msgpack ext type {code} is not one flax writes")

    def value(self):
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.value() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if tag in ints:
            v = self.unpack(ints[tag])
            return float(v) if tag in (0xCA, 0xCB) else v
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self.ext(fixext[tag])
        if tag not in lengths:
            raise ValueError(f"msgpack type byte {tag:#x} is not one flax writes")
        n = self.unpack(lengths[tag])
        if tag in (0xC4, 0xC5, 0xC6):
            return self.take(n)
        if tag in (0xD9, 0xDA, 0xDB):
            return self.str(n)
        if tag in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        if tag in (0xDE, 0xDF):
            return self.map(n)
        return self.ext(n)

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """The value msgpack ``data`` holds (strs as bytes when ``raw``)."""
    r = _Reader(data, raw)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack value")
    return out


def _chunk(arr: np.ndarray) -> dict:
    per = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + per] for i in range(0, flat.size, per)]
    return {_CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunked(tree):
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype not in _TORCH_ONLY.values():
        tree = tree.detach().cpu().numpy()
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    if isinstance(tree, torch.Tensor) and tree.numel() * tree.element_size() > MAX_CHUNK_SIZE:
        raise ValueError(f"a {tree.dtype} tensor above {MAX_CHUNK_SIZE} bytes: "
                         "chunked bfloat16 is not supported")
    return tree


def _unchunked(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunked(v) for k, v in tree.items()}


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize``: arrays above
    ``MAX_CHUNK_SIZE`` bytes chunked, then msgpack."""
    return packb(_chunked(tree))


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: msgpack, then chunked
    arrays joined."""
    return _unchunked(unpackb(data))
