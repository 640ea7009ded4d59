"""Readers: the on-disk corpora and the procedural ones.

The port's copy of the JAX package's ``data/datasets.py``. A reader returns
raw decoded planes at a fixed decode size: uint8 RGB [H,W,3], uint8 raw
label [H,W], and where the corpus has them float32 depth in metres [H,W],
uint8 HHA [H,W,3], uint8 'ir' and 'boundary' planes [H,W]. Geometry,
normalization, label remapping and HHA encoding happen on the device
(``ops/preprocess.py``). Sample for sample and batch for batch, every
reader returns what the JAX reader of the same name returns for the same
files.

Directory conventions (those of the JAX package):

  cityscapes: <root>/leftImg8bit/<split>/<city>/*_leftImg8bit.png
              <root>/gtFine/<split>/<city>/*_gtFine_labelIds.png
  gta5:       <root>/images/*.png + <root>/labels/*.png (paletted)
  synthia:    <root>/RGB/*.png + <root>/GT/LABELS/*.png
  nyu, suncg, ir:
              <root>/<split>_rgb/* + <root>/<split>_label/*
              [+ <split>_depth/ (16-bit mm) | <split>_hha/ | <split>_ir/
               | <split>_boundary/ (uint8 edge map, input_ch 7)]
  synthetic, synthetic_shifted: procedural, no files.

Files decode through the native library (``mcseg_tpu_torch.native``) with
a per-call fallback to PIL, which is imported only there. Decoded samples
are kept in a RAM cache bounded by ``DataConfig.decode_cache_gb`` and, with
``decode_disk_cache_gb``, in the disk cache of ``data/disk_cache.py``;
``io_stats`` counts the samples each tier served.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from mcseg_tpu_torch import native
from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.labels import get_label_spec


def stack(samples) -> Dict[str, np.ndarray]:
    """Per-sample dicts -> one dict of [N, ...] arrays."""
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def stack_samples(dataset, indices) -> Dict[str, np.ndarray]:
    """Stack the samples at ``indices`` into [N, ...] batch arrays."""
    return stack([dataset[int(i)] for i in indices])


def _pil_open(path: str):
    from PIL import Image  # the fallback route only: importing a reader loads no PIL

    native.note("pil")
    return Image, Image.open(path)


class SegDataset:
    """A file-list corpus returning raw decoded samples."""

    #: decode size (W, H), fixed so that batches stack
    decode_size = (640, 480)
    corpus = "nyu"
    # the disk cache opens at the geometry in effect when batches flow (``_disk``)
    _disk_cache = None
    _disk_geom = None

    def __init__(self, cfg: DataConfig, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.n_class, self.remap_table, self.names, self.palette = get_label_spec(self.corpus)
        self.samples = self._index(cfg.data_root, split)
        if cfg.max_samples:
            self.samples = self.samples[: cfg.max_samples]
        if not self.samples:
            raise FileNotFoundError(
                f"{type(self).__name__}: no samples under {cfg.data_root!r} "
                f"(split={split!r}) — check the directory layout in datasets.py")
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_bytes = 0
        self._cache_budget = int(getattr(cfg, "decode_cache_gb", 0.0) * 1e9)
        # concurrent get_batch calls (pipeline num_workers > 1) share the caches
        self._cache_lock = threading.Lock()
        self._disk_lock = threading.Lock()
        self.io_stats = {"ram_hits": 0, "disk_hits": 0, "decodes": 0}

    @property
    def _disk(self):
        geom = (tuple(self.decode_size), tuple(self.label_size))
        if self._disk_geom != geom:
            # decode threads reach here together: one of them opens (and may
            # create) the directory while the others wait
            with self._disk_lock:
                if self._disk_geom != geom:
                    from mcseg_tpu_torch.data.disk_cache import open_for_dataset

                    self._disk_cache = open_for_dataset(self)
                    self._disk_geom = geom
        return self._disk_cache

    def share_disk_cache(self, other: "SegDataset") -> None:
        """Serve ``other``'s disk-cache reads and writes from this reader's
        cache (the same corpus at the same geometry: one set of memmaps,
        opened once, here, under the lock)."""
        cache, geom = self._disk, self._disk_geom
        with other._disk_lock:
            other._disk_cache, other._disk_geom = cache, geom

    def _bump(self, key: str, n: int = 1) -> None:
        with self._cache_lock:
            self.io_stats[key] += n

    @property
    def label_size(self) -> tuple:
        """Decode size (W, H) of labels: the decode size, unless the corpus
        scores at a higher label resolution (Cityscapes' val split)."""
        return self.decode_size

    def _index(self, root: str, split: str) -> List[Dict[str, str]]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.samples)

    def _decode_rgb(self, path: str) -> np.ndarray:
        w, h = self.decode_size
        if native.available():
            try:
                out = native.decode_rgb(path, h, w)
                native.note("native")
                return out
            except IOError:
                pass
        Image, img = _pil_open(path)
        img = img.convert("RGB")
        if img.size != self.decode_size:
            img = img.resize(self.decode_size, Image.BILINEAR)
        return np.asarray(img, np.uint8)

    def _decode_label(self, path: str) -> np.ndarray:
        w, h = self.label_size
        if native.available():
            try:
                out = native.decode_gray(path, h, w)
                native.note("native")
                return out
            except IOError:
                pass
        Image, lbl = _pil_open(path)
        if lbl.size != (w, h):
            lbl = lbl.resize((w, h), Image.NEAREST)
        return np.asarray(lbl, np.uint8)

    def _decode_depth(self, path: str) -> np.ndarray:
        w, h = self.decode_size
        if native.available():
            try:
                out = native.decode_depth16(path, h, w)
                native.note("native")
                return out
            except IOError:
                pass
        Image, d = _pil_open(path)
        if d.size != self.decode_size:
            d = d.resize(self.decode_size, Image.NEAREST)
        arr = np.asarray(d)
        if np.issubdtype(arr.dtype, np.integer):
            # integer depth PNGs store millimetres: the native scale 0.001
            return arr.astype(np.float32) * 0.001
        return arr.astype(np.float32)

    def _decode_boundary(self, path: str) -> np.ndarray:
        """Edge-map plane, uint8, nonzero = edge; a nearest resize keeps it
        binary."""
        w, h = self.decode_size
        if native.available():
            try:
                out = native.decode_gray(path, h, w)
                native.note("native")
                return out
            except IOError:
                pass
        Image, b = _pil_open(path)
        b = b.convert("L")
        if b.size != self.decode_size:
            b = b.resize(self.decode_size, Image.NEAREST)
        return np.asarray(b, np.uint8)

    def _decode_ir(self, path: str) -> np.ndarray:
        Image, ir = _pil_open(path)  # the JAX reader decodes IR with PIL alone
        ir = ir.convert("L")
        if ir.size != self.decode_size:
            ir = ir.resize(self.decode_size, Image.BILINEAR)
        return np.asarray(ir, np.uint8)

    def _cache_accepting(self) -> bool:
        """Whether the RAM cache could take any further sample."""
        cache = getattr(self, "_cache", None)
        return cache is not None and self._cache_bytes < self._cache_budget

    def _cache_put(self, i: int, sample: Dict[str, np.ndarray]) -> None:
        nbytes = sum(v.nbytes for v in sample.values())
        with self._cache_lock:
            if i in self._cache or self._cache_bytes + nbytes > self._cache_budget:
                return
            self._cache[i] = sample
            self._cache_bytes += nbytes

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        cached = self._cache.get(i)
        if cached is not None:
            self._bump("ram_hits")
            return cached  # read-only: shared across epochs
        if self._disk is not None:
            hit = self._disk.get(i)
            if hit is not None:
                self._bump("disk_hits")
                self._cache_put(i, hit)
                return hit
        self._bump("decodes")
        s = self.samples[i]
        out: Dict[str, np.ndarray] = {
            "image": self._decode_rgb(s["rgb"]),
            "label": (self._decode_label(s["label"]) if s.get("label")
                      else np.full(self.label_size[::-1], 255, np.uint8)),
        }
        if "hha" in s:
            out["hha"] = self._decode_rgb(s["hha"])
        if "depth" in s:
            out["depth"] = self._decode_depth(s["depth"])
        if "ir" in s:
            out["ir"] = self._decode_ir(s["ir"])
        if "boundary" in s:
            out["boundary"] = self._decode_boundary(s["boundary"])
        self._cache_put(i, out)
        if self._disk is not None:
            self._disk.put(i, out)
        return out

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        """Decode a whole index batch into [N, ...] arrays.

        Only the samples in neither cache are decoded. With the native
        library, one call per plane decodes them on its thread pool straight
        into the batch buffers, which are returned as the batch when no
        sample came from a cache. Without it, or for an 'ir' plane or an
        unlabeled sample, the batch is stacked from ``__getitem__`` in the
        same order."""
        idx = [int(i) for i in indices]
        cache = getattr(self, "_cache", None)
        missing = [i for i in idx if i not in cache] if cache is not None else idx
        n_ram = len(idx) - len(missing)
        disk = getattr(self, "_disk", None)
        from_disk: Dict[int, Dict[str, np.ndarray]] = {}
        if disk is not None and missing:
            if len(missing) == len(idx) and disk.has_many(idx):
                out = disk.get_many(idx)
                self._bump("disk_hits", len(idx))
                if self._cache_accepting():
                    for k, i in enumerate(idx):
                        self._cache_put(i, {key: v[k].copy() for key, v in out.items()})
                return out
            for i in missing:
                hit = disk.get(i)
                if hit is not None:
                    from_disk[i] = hit
                    if cache is not None:
                        self._cache_put(i, hit)
            missing = [i for i in missing if i not in from_disk]

        def from_caches(i):
            if cache is not None and i in cache:
                return cache[i]
            return from_disk[i]

        if not missing:
            self._bump("ram_hits", n_ram)
            self._bump("disk_hits", len(from_disk))
            return stack([from_caches(i) for i in idx])
        file_list = getattr(self, "samples", None)  # procedural corpora: none
        samples = [file_list[i] for i in missing] if file_list else []
        usable = (bool(samples) and native.available()
                  and all(s.get("rgb") and s.get("label") for s in samples)
                  and not any("ir" in s for s in samples))
        if not usable:
            # __getitem__ counts its own io_stats (a row put in the RAM cache
            # from disk above counts again there as a RAM hit)
            return stack([self[i] for i in idx])
        w, h = self.decode_size
        lw, lh = self.label_size
        try:
            out: Dict[str, np.ndarray] = {
                "image": native.decode_rgb_batch([s["rgb"] for s in samples], h, w),
                "label": native.decode_gray_batch([s["label"] for s in samples], lh, lw),
            }
            if all("hha" in s for s in samples):
                out["hha"] = native.decode_rgb_batch([s["hha"] for s in samples], h, w)
            if all("depth" in s for s in samples):
                out["depth"] = native.decode_depth16_batch([s["depth"] for s in samples], h, w)
            if all("boundary" in s for s in samples):
                out["boundary"] = native.decode_gray_batch(
                    [s["boundary"] for s in samples], h, w)
        except IOError:
            return stack([self[i] for i in idx])
        native.note("native", len(samples) * len(out))
        if disk is not None:
            for k, i in enumerate(missing):
                disk.put(i, {key: v[k] for key, v in out.items()})
        self._bump("decodes", len(missing))
        if len(missing) == len(idx):
            if self._cache_accepting():
                for k, i in enumerate(missing):
                    # copies: a view would pin the whole batch buffer
                    self._cache_put(i, {key: v[k].copy() for key, v in out.items()})
            return out  # zero-copy: the decode buffers are the batch
        self._bump("ram_hits", n_ram)
        self._bump("disk_hits", len(from_disk))
        decoded = {i: {key: v[k].copy() for key, v in out.items()}
                   for k, i in enumerate(missing)}
        if cache is not None:
            for i, s in decoded.items():
                self._cache_put(i, s)
        return stack([decoded[i] if i in decoded else from_caches(i) for i in idx])


class CityscapesDataset(SegDataset):
    corpus = "city"
    decode_size = (1024, 512)
    #: the evaluation protocol scores full-resolution gtFine labels
    native_label_size = (2048, 1024)

    @property
    def label_size(self) -> tuple:
        return self.decode_size if self.split == "train" else self.native_label_size

    def _index(self, root: str, split: str):
        imgs = sorted(glob.glob(os.path.join(root, "leftImg8bit", split, "*",
                                             "*_leftImg8bit.png")))
        out = []
        for p in imgs:
            lbl = os.path.join(
                root, "gtFine", split, os.path.basename(os.path.dirname(p)),
                os.path.basename(p).replace("_leftImg8bit.png", "_gtFine_labelIds.png"))
            out.append({"rgb": p, "label": lbl if os.path.exists(lbl) else None})
        return out


class GTA5Dataset(SegDataset):
    """Paletted label PNGs: the palette index is the class id."""

    corpus = "gta5"
    decode_size = (1024, 512)

    def _index(self, root: str, split: str):
        imgs = sorted(glob.glob(os.path.join(root, "images", "*.png")))
        return [{"rgb": p, "label": os.path.join(root, "labels", os.path.basename(p))}
                for p in imgs]


class _RgbDepthLabelDataset(SegDataset):
    """The nyu/suncg/ir layout: <split>_rgb, <split>_label and optional
    <split>_depth, _hha, _ir, _boundary directories of matching stems."""

    def _index(self, root: str, split: str):
        imgs = sorted(glob.glob(os.path.join(root, f"{split}_rgb", "*")))
        out = []
        for p in imgs:
            stem = os.path.splitext(os.path.basename(p))[0]
            sample = {"rgb": p}
            lbl = self._find(root, f"{split}_label", stem)
            if lbl:
                sample["label"] = lbl
            for key in ("depth", "hha", "ir", "boundary"):
                q = self._find(root, f"{split}_{key}", stem)
                if q:
                    sample[key] = q
            out.append(sample)
        return out

    @staticmethod
    def _find(root: str, sub: str, stem: str) -> Optional[str]:
        for ext in (".png", ".jpg", ".mat.png", ".tif"):
            q = os.path.join(root, sub, stem + ext)
            if os.path.exists(q):
                return q
        return None


class NYUDv2Dataset(_RgbDepthLabelDataset):
    corpus = "nyu"
    decode_size = (640, 480)


class SynthiaDataset(SegDataset):
    """SYNTHIA-RAND-CITYSCAPES, labels through the 16-class table."""

    corpus = "synthia"
    decode_size = (1024, 512)

    def _index(self, root: str, split: str):
        imgs = sorted(glob.glob(os.path.join(root, "RGB", "*.png")))
        return [{"rgb": p, "label": os.path.join(root, "GT", "LABELS", os.path.basename(p))}
                for p in imgs]


class IRDataset(_RgbDepthLabelDataset):
    """The nyu layout plus <split>_ir/ single-channel images."""

    corpus = "ir"
    decode_size = (640, 480)


class SUNCGDataset(_RgbDepthLabelDataset):
    corpus = "suncg"
    decode_size = (640, 480)


class SyntheticDataset:
    """Procedural RGB-D scenes, deterministic per (seed, split, index):
    depth-stacked rectangles over a floor plane; class identity sets both
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

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        return stack_samples(self, indices)


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
    "city": CityscapesDataset,
    "cityscapes": CityscapesDataset,
    "gta": GTA5Dataset,
    "gta5": GTA5Dataset,
    "nyu": NYUDv2Dataset,
    "nyudv2": NYUDv2Dataset,
    "synthia": SynthiaDataset,
    "ir": IRDataset,
    "suncg": SUNCGDataset,
    "synthetic": SyntheticDataset,
    "synthetic_shifted": SyntheticShiftedDataset,
}


def get_dataset(name: str, cfg: DataConfig, split: str = "train"):
    """Reader factory. When ``<data_root>/<name>/`` exists it is that
    corpus's root, so one ``--data_root`` serves both corpora of a pair
    (``/data/gta5`` and ``/data/city`` side by side)."""
    key = name.lower()
    if key not in _CORPORA:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(set(_CORPORA))}")
    sub = os.path.join(cfg.data_root, key)
    if os.path.isdir(sub):
        cfg = dataclasses.replace(cfg, data_root=sub)
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

    def get_batch(self, indices):
        """(source batch, target batch), each through its reader's batch path."""
        return self.source.get_batch(indices), self.target.get_batch(indices)
