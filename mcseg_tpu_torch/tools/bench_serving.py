"""Serving throughput, forward only, on one card.

A random-weight model (generator seed 0), random raw planes resident on the
card, and ``--windows`` timed windows of ``--iters`` requests each through
the in-process serving path (``eval/serving.make_serve_fn``, the module
``export_serving`` freezes). No host I/O and no decode: this isolates the
device work, the rate an HTTP host in front of a warm model approaches as
client concurrency saturates the card.

    python -m mcseg_tpu_torch.tools.bench_serving --net drn_d_38 --input_ch 6 \
        --img_shape 640 480 --batch 24

Prints one line per window and one JSON summary line (the median window),
naming the card. ``--no_average`` serves F1 alone instead of the averaged
F1/F2 head, for an A/B of the head pooling.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def main(argv=None, device="cuda"):
    """Run the bench on ``device``; returns the summary dict."""
    p = argparse.ArgumentParser("bench_serving", description=__doc__.splitlines()[0])
    p.add_argument("--net", default="drn_d_38")
    p.add_argument("--input_ch", type=int, default=6)
    p.add_argument("--n_class", type=int, default=40)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--img_shape", type=int, nargs=2, default=(640, 480),
                   metavar=("W", "H"))
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--fusion", default="single", choices=("single", "late"))
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--iters", type=int, default=10, help="batches per window")
    p.add_argument("--no_average", action="store_true",
                   help="serve F1 alone (A/B baseline of the averaged head)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
    from mcseg_tpu_torch.core.device import resolve_device
    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.models.factory import init_models

    dev = resolve_device(device)
    w, h = args.img_shape
    b = args.batch
    cfg = ExperimentConfig(
        model=ModelConfig(net=args.net, input_ch=args.input_ch, n_class=args.n_class,
                          dtype=args.dtype, fusion=args.fusion),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic", batch_size=b,
                        train_img_shape=(w, h), test_img_shape=(w, h),
                        input_ch=args.input_ch))
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    serve = make_serve_fn(cfg, params, dev, average_classifiers=not args.no_average)

    r = np.random.RandomState(0)
    batch = {"image": r.randint(0, 255, (b, h, w, 3)).astype(np.uint8)}
    if args.input_ch in (1, 4, 6, 7):
        batch["depth"] = r.rand(b, h, w).astype(np.float32) * 3 + 0.5
    if args.input_ch == 7:
        batch["boundary"] = (r.rand(b, h, w) > 0.9).astype(np.uint8)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    serve(batch)  # warm-up (cuDNN picks its algorithms)
    sync()
    rates = []
    for wi in range(args.windows):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            serve(batch)
        sync()
        dt = time.perf_counter() - t0
        rates.append(b * args.iters / dt)
        print(f"window {wi}: {rates[-1]:.1f} img/s ({dt / args.iters * 1e3:.1f} ms/batch)",
              flush=True)
    summary = {
        "metric": f"serving_images_per_sec_{w}x{h}",
        "value": statistics.median(rates),
        "unit": "images/sec",
        "ms_per_batch": b / statistics.median(rates) * 1e3,
        "net": args.net, "batch": b, "input_ch": args.input_ch, "dtype": args.dtype,
        "averaged_head": not args.no_average,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
