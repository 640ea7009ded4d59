"""Per-stage breakdown of the host input-pipeline assembly path.

The port of the JAX package's ``tools/profile_input_pipeline.py``, with its
flags, on the port's readers (``data/datasets.py``), disk cache
(``data/disk_cache.py``) and stream (``data/pipeline.py``): the decoded
corpus served from the disk cache (RAM cache off, epoch >= 2) of a real or
synthetic NYU-layout corpus. It times each assembly stage of one batch —
memmap ``has_many`` / per-plane fancy-index ``get_many`` / full
``get_batch`` / ``ZipDataset`` pair / ``wire_format`` — then the
``batch_iterator`` steady state over ``--windows`` windows with the
``io_stats`` tier counters that show which tier served them. Source and
target share one disk cache (``SegDataset.share_disk_cache``), which the
port opens under a lock, so decode threads starting together never race
to create it.

    python -m mcseg_tpu_torch.tools.profile_input_pipeline \\
        --data_root /tmp/corpus --synth 48 --batch 24 --img_shape 640x480

Host only: nothing here touches a card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time


def _synth_corpus(root: str, n: int, w: int, h: int) -> None:
    """NYU-layout synthetic PNG corpus (rgb + label + 16-bit-mm depth) from
    ``RandomState(0)``, the JAX tool's, idempotent via a .complete marker
    recording (n, w, h)."""
    import numpy as np
    from PIL import Image

    done = os.path.join(root, ".complete")
    if os.path.exists(done):
        with open(done) as f:
            parts = f.read().strip().split(",")
        if len(parts) == 3 and all(p.isdigit() for p in parts):
            have_n, have_w, have_h = (int(p) for p in parts)
            if have_n >= n and (have_w, have_h) == (w, h):
                return
    for sub in ("train_rgb", "train_label", "train_depth"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        rgb = rng.randint(0, 255, (h, w, 3), np.uint8)
        lbl = rng.randint(0, 41, (h, w)).astype(np.uint8)
        depth = (rng.rand(h, w) * 4000 + 500).astype(np.uint16)
        Image.fromarray(rgb).save(os.path.join(root, "train_rgb", f"{i:05d}.png"))
        Image.fromarray(lbl).save(os.path.join(root, "train_label", f"{i:05d}.png"))
        Image.fromarray(depth).save(os.path.join(root, "train_depth", f"{i:05d}.png"))
    with open(done, "w") as f:
        f.write(f"{n},{w},{h}")


def _timeit(fn, n: int = 20) -> float:
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3  # ms


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_root", required=True,
                   help="corpus root (NYU layout: <split>_rgb/label/depth)")
    p.add_argument("--dataset", default="nyu")
    p.add_argument("--split", default="train")
    p.add_argument("--synth", type=int, default=0, metavar="N",
                   help="synthesize an N-image corpus at --img_shape first")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--img_shape", default="640x480", metavar="WxH")
    p.add_argument("--input_ch", type=int, default=6)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--disk_cache_gb", type=float, default=8.0)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--steps_per_window", type=int, default=6)
    args = p.parse_args(argv)
    w, h = (int(v) for v in args.img_shape.split("x"))
    b = args.batch

    import numpy as np

    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
    from mcseg_tpu_torch.data.pipeline import batch_iterator, wire_format

    if args.synth:
        _synth_corpus(args.data_root, args.synth, w, h)

    cfg = DataConfig(
        src_dataset=args.dataset, tgt_dataset=args.dataset, batch_size=b,
        train_img_shape=(w, h), input_ch=args.input_ch,
        num_workers=args.num_workers, data_root=args.data_root,
        decode_cache_gb=0.0, decode_disk_cache_gb=args.disk_cache_gb,
        decode_disk_cache_dir=os.path.join(args.data_root, ".profile_dcache"))
    src = get_dataset(args.dataset, cfg, args.split)
    tgt = get_dataset(args.dataset, cfg, args.split)
    src.decode_size = tgt.decode_size = (w, h)
    src.share_disk_cache(tgt)  # same corpus + geometry: one cache
    n = len(src)
    if n < b:
        raise SystemExit(f"corpus has {n} images < batch {b}")

    # epoch 1 fills the disk cache (one-time decode cost, not profiled)
    it = batch_iterator(ZipDataset(src, tgt), b, seed=0, num_workers=args.num_workers)
    for _ in range(n // b + 1):
        next(it)
    it.close()
    idx = list(range(b))
    disk = src._disk
    if disk is None or not disk.has_many(idx):
        raise SystemExit("disk cache did not fill — is --disk_cache_gb "
                         "large enough for this corpus?")

    stages = {}
    print(f"per-batch stage timings (ms, median of 20), batch={b} @ {w}x{h}:")
    stages["has_many"] = _timeit(lambda: disk.has_many(idx))
    print(f"  has_many            {stages['has_many']:8.2f}")
    for name, m in disk._maps.items():
        ix = np.asarray(idx)
        stages[f"get_many[{name}]"] = _timeit(lambda m=m, ix=ix: np.asarray(m[ix]))
        print(f"  get_many[{name:7s}]  {stages[f'get_many[{name}]']:8.2f}")
    stages["get_many (all)"] = _timeit(lambda: disk.get_many(idx))
    print(f"  get_many (all)      {stages['get_many (all)']:8.2f}")
    stages["ds.get_batch"] = _timeit(lambda: src.get_batch(idx))
    print(f"  ds.get_batch        {stages['ds.get_batch']:8.2f}")
    zd = ZipDataset(src, tgt)
    stages["zip.get_batch"] = _timeit(lambda: zd.get_batch(idx))
    print(f"  zip.get_batch       {stages['zip.get_batch']:8.2f}")
    batch = src.get_batch(idx)
    stages["wire_format(src)"] = _timeit(lambda: wire_format(batch))
    print(f"  wire_format(src)    {stages['wire_format(src)']:8.2f}")
    stages["wire_format(tgt,dl)"] = _timeit(lambda: wire_format(batch, drop_label=True))
    print(f"  wire_format(tgt,dl) {stages['wire_format(tgt,dl)']:8.2f}")

    # steady state through batch_iterator (the JAX package's bench number)
    it = batch_iterator(ZipDataset(src, tgt), b, seed=0, num_workers=args.num_workers)
    for _ in range(n // b + 1):
        next(it)
    rates = []
    dec0 = src.io_stats["decodes"] + tgt.io_stats["decodes"]
    for _ in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.steps_per_window):
            next(it)
        rates.append(2.0 * b * args.steps_per_window / (time.perf_counter() - t0))
    dec = src.io_stats["decodes"] + tgt.io_stats["decodes"] - dec0
    it.close()
    print(f"  batch_iterator steady state: {[round(r, 1) for r in rates]} "
          f"img/s, median {statistics.median(rates):.1f}")
    print("  io_stats src:", src.io_stats, " tgt:", tgt.io_stats)
    print(f"  timed-window decodes: {dec} "
          f"({'disk tier served everything' if dec == 0 else 'NOT warm'})")
    return {"stage_ms": stages, "steady_img_per_s": rates,
            "io_stats": {"src": dict(src.io_stats), "tgt": dict(tgt.io_stats)},
            "timed_window_decodes": dec}


if __name__ == "__main__":
    main()
