"""ctypes bindings of the native host decoder (``decoder.cpp``).

The port's counterpart of the JAX package's ``mcseg_tpu/native``: the same
C++ source and C interface, decoding PNG (libpng) and JPEG (libjpeg)
straight into preallocated numpy buffers, with a thread pool for batches.

Nothing is built at import. The first ``available()`` call compiles the
library with g++ into ``build/native/libmcseg_decoder-<hash>.so`` at the
repository root (``build/`` is git-ignored; the hash covers the source and
the flags, so an edit rebuilds). Where it cannot be built (no compiler, no
libpng or libjpeg headers), ``available()`` is False and the readers decode
with PIL, as the JAX package does; ``MCSEG_NO_NATIVE=1`` switches the
library off. ``routes`` counts the files each route decoded in this
process, and ``build_report()`` says how the build went.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_report: Dict[str, object] = {}

#: files decoded per route in this process ("native" or "pil")
routes = {"native": 0, "pil": 0}


def note(route: str, n: int = 1) -> None:
    """Count ``n`` files decoded by ``route``."""
    with _lock:
        routes[route] += n


def library_path() -> Path:
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmcseg_decoder-{digest}.so"


def _build(out: Path) -> Optional[str]:
    """Compile ``decoder.cpp`` into ``out``; None on success, else why not."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        return f"{type(e).__name__}: {e}"
    try:
        if proc.returncode != 0:
            return proc.stderr.strip()[-2000:] or f"g++ exited {proc.returncode}"
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        return None
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = library_path()
        t0 = time.perf_counter()
        error = None if out.exists() else _build(out)
        _report.update(seconds=time.perf_counter() - t0, built=error is None,
                       error=error, path=str(out))
        if error is not None:
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:
            _report.update(built=False, error=str(e))
            return None
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        paths = ctypes.POINTER(ctypes.c_char_p)
        i = ctypes.c_int
        lib.mcseg_decode_rgb.argtypes = [ctypes.c_char_p, u8p, i, i]
        lib.mcseg_decode_gray.argtypes = [ctypes.c_char_p, u8p, i, i]
        lib.mcseg_decode_depth16.argtypes = [ctypes.c_char_p, f32p, i, i, ctypes.c_float]
        lib.mcseg_decode_rgb_batch.argtypes = [paths, i, u8p, i, i, i]
        lib.mcseg_decode_gray_batch.argtypes = [paths, i, u8p, i, i, i]
        lib.mcseg_decode_depth16_batch.argtypes = [paths, i, f32p, i, i, ctypes.c_float, i]
        for fn in ("mcseg_decode_rgb", "mcseg_decode_gray", "mcseg_decode_depth16",
                   "mcseg_decode_rgb_batch", "mcseg_decode_gray_batch",
                   "mcseg_decode_depth16_batch"):
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call) and not switched off by ``MCSEG_NO_NATIVE=1``."""
    return _load() is not None and os.environ.get("MCSEG_NO_NATIVE") != "1"


def build_report() -> Dict[str, object]:
    """{seconds, built, error, path} of this process's build attempt (empty
    before the first ``available()``)."""
    with _lock:
        return dict(_report)


def _check(rc: int, what: str) -> None:
    if rc:
        raise IOError(f"native decode failed ({rc}) for {what}")


def decode_rgb(path: str, h: int, w: int) -> np.ndarray:
    out = np.empty((h, w, 3), np.uint8)
    _check(_load().mcseg_decode_rgb(path.encode(), out, h, w), path)
    return out


def decode_gray(path: str, h: int, w: int) -> np.ndarray:
    out = np.empty((h, w), np.uint8)
    _check(_load().mcseg_decode_gray(path.encode(), out, h, w), path)
    return out


def decode_depth16(path: str, h: int, w: int, scale: float = 0.001) -> np.ndarray:
    out = np.empty((h, w), np.float32)
    _check(_load().mcseg_decode_depth16(path.encode(), out, h, w, scale), path)
    return out


def auto_threads(n_threads: int = 0) -> int:
    """Threads of one batch call: ``n_threads``, or min(cores, 8) for 0."""
    if n_threads <= 0:
        n_threads = min(max(os.cpu_count() or 1, 1), 8)
    return n_threads


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def decode_rgb_batch(paths: Sequence[str], h: int, w: int,
                     n_threads: int = 0) -> np.ndarray:
    out = np.empty((len(paths), h, w, 3), np.uint8)
    _check(_load().mcseg_decode_rgb_batch(_paths(paths), len(paths), out, h, w,
                                          auto_threads(n_threads)), "a batch")
    return out


def decode_gray_batch(paths: Sequence[str], h: int, w: int,
                      n_threads: int = 0) -> np.ndarray:
    out = np.empty((len(paths), h, w), np.uint8)
    _check(_load().mcseg_decode_gray_batch(_paths(paths), len(paths), out, h, w,
                                           auto_threads(n_threads)), "a batch")
    return out


def decode_depth16_batch(paths: Sequence[str], h: int, w: int,
                         scale: float = 0.001, n_threads: int = 0) -> np.ndarray:
    out = np.empty((len(paths), h, w), np.float32)
    _check(_load().mcseg_decode_depth16_batch(_paths(paths), len(paths), out, h, w,
                                              scale, auto_threads(n_threads)), "a batch")
    return out
