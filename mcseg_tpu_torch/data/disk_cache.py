"""Decoded-corpus disk cache: decode each file once, then read by mmap.

The port's copy of the JAX package's ``data/disk_cache.py``: the same
``_VERSION``, directory name, fingerprint and plane layout, so that a cache
directory either package wrote, the other reads. Corpora larger than the
card (``data/device_corpus.py``) and than the RAM cache
(``DataConfig.decode_cache_gb``) would otherwise decode most samples every
epoch; this cache writes each decoded sample once into raw plane files, and
later epochs and later runs assemble batches from them without decoding.

Layout (one directory per (corpus, split, geometry)):

    <dir>/meta.json     {version, key, n, cached_n, planes}
    <dir>/filled.u8     uint8[cached_n]   1 = row is valid
    <dir>/<plane>.raw   dtype[cached_n, *shape] per plane (image/label/...)

The ``key`` fingerprints the sample file list, each file's (st_size,
st_mtime_ns) and the decode geometry; any change (other files, a file
regenerated in place, another decode size) wipes and rebuilds the
directory instead of serving stale pixels. A change of the budget
(``--decode_disk_cache_gb``) alone grows or truncates the plane files in
place and keeps every valid row. The cache stores exactly what
``SegDataset.__getitem__`` returns (uint8 RGB/label/HHA/IR/boundary, float32
depth in metres), so the stream is bit-identical with the cache off, empty,
partly filled or full.

Budget: ``decode_disk_cache_gb`` bounds the directory; when the decoded
corpus is larger, the index prefix that fits is cached and the rest decodes
every epoch.

Crash safety: a row's ``filled`` byte is written after its plane rows, so a
process killed mid-write leaves filled=0 and the sample decodes again.
Concurrent writers (pipeline ``num_workers`` > 1) write identical bytes, so
no lock is needed.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_VERSION = 1


def _fingerprint(paths: List[str], sizes: Dict[str, Tuple[int, ...]]) -> str:
    h = hashlib.sha256()
    h.update(json.dumps({"v": _VERSION, "sizes": {k: list(v) for k, v in
                                                  sorted(sizes.items())}},
                        sort_keys=True).encode())
    for p in paths:
        h.update(p.encode())
        h.update(b"\0")
        if p:
            # content identity: a corpus file regenerated in place (same path,
            # new bytes) invalidates the cache
            try:
                st = os.stat(p)
                h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
            except OSError:
                pass
        h.update(b"\1")
    return h.hexdigest()[:32]


class DiskDecodeCache:
    """Raw-plane memmap cache for decoded samples.

    ``planes`` maps plane name -> (shape, numpy dtype str) for one sample.
    Rows [0, cached_n) are cacheable; ``covers(i)``/``get(i)``/``put(i, s)``
    are the per-sample API and ``get_many(idx)`` the vectorized batch read.
    """

    def __init__(self, directory: str, key: str, n: int,
                 planes: Dict[str, Tuple[Tuple[int, ...], str]],
                 budget_gb: float):
        self.dir = directory
        per_sample = sum(
            int(np.prod(shape)) * np.dtype(dt).itemsize
            for shape, dt in planes.values()
        ) + 1  # + filled byte
        cached_n = min(n, int(budget_gb * 1e9) // per_sample)
        if cached_n <= 0:
            raise ValueError(
                f"decode_disk_cache_gb={budget_gb} smaller than one sample "
                f"({per_sample / 1e6:.1f} MB)")
        self.cached_n = int(cached_n)
        self.planes = dict(planes)
        self.key = key

        meta_path = os.path.join(directory, "meta.json")
        meta = None
        if os.path.exists(meta_path):
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = None
        expected = {
            "version": _VERSION, "key": key, "n": n, "cached_n": self.cached_n,
            "planes": {name: {"shape": list(shape), "dtype": dt}
                       for name, (shape, dt) in planes.items()},
        }

        def _core(m):
            # identity fields only: cached_n follows the budget, and a change
            # of --decode_disk_cache_gb alone keeps the valid rows
            return {k: m.get(k) for k in ("version", "key", "n", "planes")}

        if (isinstance(meta, dict) and _core(meta) == _core(expected)
                and meta.get("cached_n") != self.cached_n):
            # budget-only change: grow (zero-fill => filled=0, rows decode on
            # demand) or truncate the memmap files in place
            try:
                for name, (shape, dt) in planes.items():
                    row = int(np.prod(shape)) * np.dtype(dt).itemsize
                    with open(os.path.join(directory, f"{name}.raw"),
                              "r+b") as f:
                        f.truncate(self.cached_n * row)
                with open(os.path.join(directory, "filled.u8"), "r+b") as f:
                    f.truncate(self.cached_n)
                tmp = meta_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(expected, f)
                os.replace(tmp, meta_path)
                meta = expected
            except OSError:
                meta = None  # torn cache (missing plane file): wipe below
        if meta != expected:
            # stale / foreign / torn cache: wipe and restart (never serve
            # pixels whose provenance doesn't match this corpus + geometry)
            if os.path.isdir(directory):
                shutil.rmtree(directory)
            os.makedirs(directory, exist_ok=True)
            for name, (shape, dt) in planes.items():
                np.memmap(os.path.join(directory, f"{name}.raw"), dtype=dt,
                          mode="w+", shape=(self.cached_n, *shape)).flush()
            np.memmap(os.path.join(directory, "filled.u8"), dtype=np.uint8,
                      mode="w+", shape=(self.cached_n,)).flush()
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(expected, f)
            os.replace(tmp, meta_path)

        self._maps = {
            name: np.memmap(os.path.join(directory, f"{name}.raw"), dtype=dt,
                            mode="r+", shape=(self.cached_n, *shape))
            for name, (shape, dt) in planes.items()
        }
        self._filled = np.memmap(os.path.join(directory, "filled.u8"),
                                 dtype=np.uint8, mode="r+",
                                 shape=(self.cached_n,))

    # ------------------------------------------------------------------ API
    def covers(self, i: int) -> bool:
        return 0 <= i < self.cached_n

    def has(self, i: int) -> bool:
        return self.covers(i) and bool(self._filled[i])

    def get(self, i: int) -> Optional[Dict[str, np.ndarray]]:
        if not self.has(i):
            return None
        return {name: np.array(m[i]) for name, m in self._maps.items()}

    def put(self, i: int, sample: Dict[str, np.ndarray]) -> None:
        if not self.covers(i) or self._filled[i]:
            return
        if set(sample) != set(self._maps):  # plane set drifted mid-run
            return
        if any(sample[name].shape != m.shape[1:]
               for name, m in self._maps.items()):
            return  # decode geometry mutated post-open; never store mismatched
        for name, m in self._maps.items():
            m[i] = sample[name]
        self._filled[i] = 1  # last: torn writes re-decode, never mis-serve

    def has_many(self, idx: Sequence[int]) -> bool:
        return all(self.has(int(i)) for i in idx)

    def get_many(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stacked [N, ...] batch read (fancy-index on the memmaps)."""
        ix = np.asarray([int(i) for i in idx])
        return {name: np.asarray(m[ix]) for name, m in self._maps.items()}

    def flush(self) -> None:
        for m in self._maps.values():
            m.flush()
        self._filled.flush()


def open_for_dataset(ds) -> Optional[DiskDecodeCache]:
    """Build the cache for a file-backed SegDataset, or None when disabled /
    not applicable (procedural corpora, unwritable corpus root, zero budget).

    The directory lives next to the corpus:
    ``<data_root>/.mcseg_decode_cache/<corpus>_<split>_<W>x<H>/``
    (override root with DataConfig.decode_disk_cache_dir for read-only
    corpus mounts).
    """
    budget = float(getattr(ds.cfg, "decode_disk_cache_gb", 0.0) or 0.0)
    samples = getattr(ds, "samples", None)
    if budget <= 0.0 or not samples:
        return None
    w, h = ds.decode_size
    lw, lh = ds.label_size
    planes: Dict[str, Tuple[Tuple[int, ...], str]] = {
        "image": ((h, w, 3), "uint8"),
        "label": ((lh, lw), "uint8"),
    }
    s0 = samples[0]
    if "depth" in s0:
        planes["depth"] = ((h, w), "float32")
    if "hha" in s0:
        planes["hha"] = ((h, w, 3), "uint8")
    if "ir" in s0:
        planes["ir"] = ((h, w), "uint8")
    if "boundary" in s0:
        planes["boundary"] = ((h, w), "uint8")
    paths = [s.get(k) or "" for s in samples
             for k in ("rgb", "label", "depth", "hha", "ir", "boundary")]
    key = _fingerprint(paths, {"img": (h, w), "lbl": (lh, lw)})
    root = getattr(ds.cfg, "decode_disk_cache_dir", "") or os.path.join(
        ds.cfg.data_root, ".mcseg_decode_cache")
    directory = os.path.join(root, f"{ds.corpus}_{ds.split}_{w}x{h}")
    try:
        return DiskDecodeCache(directory, key, len(samples), planes, budget)
    except (OSError, ValueError) as e:  # read-only mount / budget < 1 sample
        import sys

        print(f"[mcseg] decode disk cache disabled: {e}", file=sys.stderr)
        return None
