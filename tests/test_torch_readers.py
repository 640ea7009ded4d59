"""The port's on-disk readers, batch stream and decode caches against the JAX
package's, on the same files.

The layouts are those of ``tests/test_corpus_layouts.py`` (its make_* functions:
64x32 PNG files, two per split), decoded by each reader at its own decode
size. Every sample (``__getitem__``) and every batch (``get_batch``) of
every corpus and alias is bit-equal to the JAX reader's, through the
native decoder and through the PIL route (``MCSEG_NO_NATIVE=1`` on both
sides). The stream (``batch_iterator`` over a ZipDataset: serial, on two
decode threads, resumed at epoch 1) is bit-equal to JAX's for the same
seed, and stays so with the RAM cache on, off and full, and with the disk
cache empty, partly filled and full; ``io_stats`` counts the tier that
served, as ``tests/test_disk_cache.py`` does for JAX. A cache directory
written by either package reads back bit-equal through the other.
``wire_format`` equals JAX's, and on the CPU the prefetching stream and
the card-resident corpus yield the host stream's tensors.
"""

import os

import numpy as np
import pytest
import torch

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.data.datasets import ZipDataset as JaxZipDataset
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.data.pipeline import batch_iterator as jax_batch_iterator
from mcseg_tpu.data.pipeline import wire_format as jax_wire_format
from mcseg_tpu_torch import native
from mcseg_tpu_torch.core.config import DataConfig
from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
from mcseg_tpu_torch.data.device_corpus import corpus_stream
from mcseg_tpu_torch.data.disk_cache import DiskDecodeCache
from mcseg_tpu_torch.data.pipeline import batch_iterator, device_prefetch, wire_items
from tests.test_corpus_layouts import make_cityscapes, make_gta5, make_nyu_like, make_synthia
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One data root with every corpus in its ``<root>/<name>/`` folder."""
    r = tmp_path_factory.mktemp("corpora")
    make_cityscapes(r / "city")
    make_gta5(r / "gta5", n=3)
    make_synthia(r / "synthia")
    make_nyu_like(r / "nyu", n=3, with_hha=True, with_boundary=True)
    make_nyu_like(r / "suncg", n=3, splits=("train",), with_boundary=True)
    ir = r / "ir"
    make_nyu_like(ir, splits=("train",), with_depth=False)
    rng = np.random.RandomState(3)
    os.makedirs(ir / "train_ir")
    from PIL import Image

    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (32, 64), np.uint8)).save(ir / "train_ir" / f"{i:05d}.png")
    os.makedirs(r / "unlabeled" / "leftImg8bit" / "test" / "cityB")  # a split without labels
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (32, 64, 3), np.uint8)).save(
            r / "unlabeled" / "leftImg8bit" / "test" / "cityB" / f"cityB_{i:06d}_000019_leftImg8bit.png")
    for alias, name in (("cityscapes", "city"), ("gta", "gta5"), ("nyudv2", "nyu")):
        os.symlink(r / name, r / alias)  # <data_root>/<name>/ resolves for every alias
    return r


def _cfgs(root, **kw):
    kw = {"data_root": str(root), "batch_size": 2, **kw}
    return DataConfig(**kw), JaxDataConfig(**kw)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


CORPORA = [("city", "train"), ("cityscapes", "val"), ("gta", "train"), ("gta5", "train"),
           ("nyu", "train"), ("nyudv2", "val"), ("synthia", "train"), ("ir", "train"),
           ("suncg", "train")]


@pytest.fixture(params=["native", "pil"])
def route(request, monkeypatch):
    if request.param == "native" and not native.available():
        pytest.skip(f"native decoder unavailable here: {native.build_report()}")
    if request.param == "pil":
        monkeypatch.setenv("MCSEG_NO_NATIVE", "1")
    return request.param


@pytest.mark.parametrize("name,split", CORPORA)
def test_every_reader_matches_jax(root, route, name, split):
    cfg, jcfg = _cfgs(root, decode_cache_gb=0.0)
    ds, jds = get_dataset(name, cfg, split), jax_get_dataset(name, jcfg, split)
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) >= 2 and ds.samples == jds.samples
    assert ds.decode_size == jds.decode_size and ds.label_size == jds.label_size
    before = dict(native.routes)
    for i in range(len(ds)):
        _equal(ds[i], jds[i])
    idx = [1, 0, 1]
    _equal(ds.get_batch(idx), jds.get_batch(idx))
    used = {k for k in native.routes if native.routes[k] > before[k]}
    # 'ir' planes decode with PIL on both routes, as in the JAX reader
    assert used == ({"pil"} if route == "pil" else {"native", "pil"} if name == "ir"
                    else {"native"})


def test_layout_specifics(root):
    cfg, _ = _cfgs(root)
    val = get_dataset("city", cfg, "val")
    s = val[0]
    assert s["image"].shape == (512, 1024, 3) and s["label"].shape == (1024, 2048)
    assert get_dataset("city", cfg, "train")[0]["label"].shape == (512, 1024)
    assert get_dataset("gta5", cfg, "train")[0]["label"].max() <= 33  # palette indices
    nyu = get_dataset("nyu", cfg, "train")[0]
    assert set(nyu) == {"image", "label", "depth", "hha", "boundary"}
    assert nyu["depth"].dtype == np.float32 and 0.4 < nyu["depth"].mean() < 5.0
    assert set(get_dataset("ir", cfg, "train")[0]) == {"image", "label", "ir"}
    # an unlabeled split decodes all-ignore labels at the label size
    test = get_dataset("city", _cfgs(root / "unlabeled")[0], "test")
    assert (test[0]["label"] == 255).all() and test[0]["label"].shape == (1024, 2048)
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset("kitti", cfg)
    with pytest.raises(FileNotFoundError, match="no samples"):
        get_dataset("nyu", _cfgs(root / "gta5")[0], "train")


def _stream(mod_get, mod_zip, mod_iter, cfg, **kw):
    z = mod_zip(mod_get("suncg", cfg, "train"), mod_get("nyu", cfg, "train"))
    return z, list(mod_iter(z, 2, seed=5, epochs=3, **kw))


def _equal_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _equal(a, b)


@pytest.mark.parametrize("num_workers,start_epoch", [(0, 0), (2, 0), (0, 1), (2, 1)])
def test_stream_matches_jax(root, num_workers, start_epoch):
    cfg, jcfg = _cfgs(root)
    _, want = _stream(jax_get_dataset, JaxZipDataset, jax_batch_iterator, jcfg,
                      start_epoch=start_epoch)
    _, got = _stream(get_dataset, ZipDataset, batch_iterator, cfg,
                     num_workers=num_workers, start_epoch=start_epoch)
    assert len(got) == 3 - start_epoch  # 3 samples, batch 2, the tail dropped
    _equal_stream(got, want)


def _both(root, tmp_path=None, **kw):
    """The port's and JAX's streams and zipped readers on one configuration,
    each package with its own disk cache directory."""
    if tmp_path is not None:
        kw["decode_disk_cache_dir"] = str(tmp_path / "port")
    z, got = _stream(get_dataset, ZipDataset, batch_iterator, _cfgs(root, **kw)[0])
    if tmp_path is not None:
        kw["decode_disk_cache_dir"] = str(tmp_path / "jax")
    jz, want = _stream(jax_get_dataset, JaxZipDataset, jax_batch_iterator, _cfgs(root, **kw)[1])
    _equal_stream(got, want)
    for ours, theirs in ((z.source, jz.source), (z.target, jz.target)):
        assert ours.io_stats == theirs.io_stats
        assert sorted(ours._cache) == sorted(theirs._cache)
    return z.target


def test_ram_cache_on_off_full(root):
    per_sample = 640 * 480 * (3 + 1 + 4 + 3 + 1)  # rgb, label, depth, hha, boundary
    off = _both(root, decode_cache_gb=0.0)
    assert off.io_stats == {"ram_hits": 0, "disk_hits": 0, "decodes": 6} and not off._cache
    on = _both(root, decode_cache_gb=1.0)  # each sample decoded once
    assert on.io_stats == {"ram_hits": 3, "disk_hits": 0, "decodes": 3}
    full = _both(root, decode_cache_gb=2.5 * per_sample / 1e9)  # room for two
    assert len(full._cache) == 2 and full._cache_bytes == 2 * per_sample
    assert full.io_stats["ram_hits"] > 0


def test_disk_cache_empty_partial_full(root, tmp_path):
    per_sample = 640 * 480 * (3 + 1 + 4 + 3 + 1) + 1
    kw = dict(decode_cache_gb=0.0)
    partial = _both(root, tmp_path, decode_disk_cache_gb=1.5 * per_sample / 1e9, **kw)
    assert partial._disk.cached_n == 1  # the prefix that fits: row 0
    assert partial.io_stats["disk_hits"] > 0 and partial.io_stats["decodes"] > 3
    _both(root, tmp_path, decode_disk_cache_gb=1.0, **kw)  # grown in place, filled
    warm = _both(root, tmp_path, decode_disk_cache_gb=1.0, **kw)
    assert warm.io_stats == {"ram_hits": 0, "disk_hits": 6, "decodes": 0}
    with_ram = _both(root, tmp_path, decode_disk_cache_gb=1.0, decode_cache_gb=1.0)
    assert with_ram.io_stats["decodes"] == 0 and with_ram.io_stats["ram_hits"] > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_cache_directory_shared_with_jax(root, tmp_path, writer):
    kw = dict(decode_cache_gb=0.0, decode_disk_cache_gb=1.0,
              decode_disk_cache_dir=str(tmp_path / "cache"))
    cfg, jcfg = _cfgs(root, **kw)
    first, second = (jax_get_dataset, get_dataset) if writer == "jax" else (get_dataset, jax_get_dataset)
    src = first("nyu", jcfg if writer == "jax" else cfg, "train")
    want = [src[i] for i in range(len(src))]
    entries = os.listdir(tmp_path / "cache")
    assert entries == ["nyu_train_640x480"]
    dst = second("nyu", cfg if writer == "jax" else jcfg, "train")
    for i, w in enumerate(want):
        _equal(dst[i], w)
    assert dst.io_stats == {"ram_hits": 0, "disk_hits": 3, "decodes": 0}
    assert isinstance(dst._disk, DiskDecodeCache) == (writer == "jax")


def test_wire_format_prefetch_and_device_corpus_on_cpu(root):
    cfg, _ = _cfgs(root, decode_cache_gb=1.0)
    z, host = _stream(get_dataset, ZipDataset, batch_iterator, cfg)
    for h in host:
        for ours, theirs in zip(wire_items(h), (jax_wire_format(h[0]),
                                                jax_wire_format(h[1], drop_label=True))):
            _equal(ours, theirs)
    wired = [wire_items(h) for h in host]
    assert "label" not in wired[0][1] and wired[0][0]["depth"].dtype == np.uint16
    pre = list(device_prefetch(batch_iterator(z, 2, seed=5, epochs=3, num_workers=2), "cpu"))
    staged = list(corpus_stream(z, "cpu", 2, seed=5, epochs=3))
    for stream in (pre, staged):
        assert len(stream) == len(wired)
        for got, want in zip(stream, wired):
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    assert torch.equal(g[k], torch.from_numpy(w[k])), k


def test_concurrent_batches_keep_the_caches_consistent(root, tmp_path):
    """16 threads (more than the cores) call ``get_batch`` on one reader at
    once, with a short switch interval: every load is counted once, the RAM
    cache's byte count is the sum of what it holds, the disk cache opens
    once, and every batch equals the serial decode."""
    import sys
    import threading

    cfg = _cfgs(root, decode_cache_gb=1.0, decode_disk_cache_gb=1.0,
                decode_disk_cache_dir=str(tmp_path / "cache"))[0]
    ds = get_dataset("nyu", cfg, "train")
    want = [get_dataset("nyu", _cfgs(root, decode_cache_gb=0.0)[0], "train")[i] for i in range(3)]
    rng = np.random.RandomState(0)
    jobs = [list(rng.randint(0, 3, 2)) for _ in range(64)]
    errors = []

    def work(mine):
        try:
            for idx in mine:
                got = ds.get_batch(idx)
                for k, i in enumerate(idx):
                    for key in want[i]:
                        if not np.array_equal(got[key][k], want[i][key]):
                            raise AssertionError(f"sample {i} plane {key}")
        except Exception as e:  # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(jobs[t::16],)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sum(ds.io_stats.values()) == 2 * len(jobs)
    assert ds._cache_bytes == sum(v.nbytes for s in ds._cache.values() for v in s.values())
    assert sorted(ds._cache) == [0, 1, 2] and ds._disk is not None
    assert all(ds._disk.has(i) for i in range(3))
