"""Peak card memory of the MCD train iteration against the batch and the
spatial-partitioning extent (``--spatial_devices``).

The port of the JAX package's ``tools/spatial_memory_table.py``, with its
flags where they apply. There, XLA's ``compiled.memory_analysis()`` of the
AOT-compiled step gives the bytes; here one iteration runs on the card and
``torch.cuda.max_memory_allocated`` reads its peak, so every number is the
card's. The model is the JAX tool's: ``--net`` (any trunk: DRN, PSPNet,
or FCN8s with the height a multiple of 32 x the extent) RGB+HHA, 40 classes,
bf16, SGD, ``--num_k`` generator updates, random weights from seed 0, raw
planes (uint8 RGB, float32 depth, labels) drawn on the card.

  * ``--mode fit``: one process, one iteration at each batch of
    ``--batches`` at ``--img_shape``; a batch whose peak reaches
    ``--hbm_gb`` or that runs out of memory does not fit.
  * ``--mode spatial``: for each extent s (1, 2, 4 ... up to
    ``--n_devices``) one iteration at one image per data row (a global batch
    of 1) on s ranks, each holding 1/s of the image's rows (gloo when the
    ranks share a card, NCCL with a card each); every rank's peak.

    python -m mcseg_tpu_torch.tools.spatial_memory_table --mode fit \\
        --img_shape 640x480 --batches 8,16,32
    python -m mcseg_tpu_torch.tools.spatial_memory_table --mode spatial \\
        --img_shape 2048x1024 --n_devices 4

Each row prints as one JSON line; the tool returns the rows.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
from typing import Dict, List, Optional

import torch

from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.parallel.spatial import check_spatial

GB = 1e9


def _config(w: int, h: int, batch: int, net: str, num_k: int) -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(net=net, input_ch=6, n_class=40, dtype="bfloat16"),
        data=DataConfig(src_dataset="suncg", tgt_dataset="nyu", batch_size=batch,
                        train_img_shape=(w, h), test_img_shape=(w, h), input_ch=6,
                        hha_on_device=True),
        train=TrainConfig(lr=1e-3, num_k=num_k, max_steps=100_000))


def _raw(batch: int, h: int, w: int, device, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A raw batch on ``device``: uint8 RGB, depth in metres (0.5-10 m),
    NYU-range labels."""
    return {"image": torch.randint(0, 256, (batch, h, w, 3), generator=gen, device=device,
                                   dtype=torch.uint8),
            "depth": torch.rand((batch, h, w), generator=gen, device=device) * 9.5 + 0.5,
            "label": torch.randint(0, 41, (batch, h, w), generator=gen, device=device,
                                   dtype=torch.uint8)}


def _one_iteration(cfg: ExperimentConfig, device, dp=None) -> int:
    """Peak bytes allocated on ``device`` over one MCD iteration from a
    fresh state (the state and its inputs included)."""
    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    state = create_train_state(cfg.model, cfg.train, 0, device)
    state.broadcast_from_primary(dp)
    state.set_data_parallel(dp)
    gen = torch.Generator(device=device).manual_seed(1)
    h, w = cfg.data.train_img_shape[1], cfg.data.train_img_shape[0]
    src, tgt = (_raw(cfg.data.batch_size, h, w, device, gen) for _ in range(2))
    metrics = make_adapt_iteration(cfg, dp)(state, src, tgt)
    float(metrics["loss_dis"])  # the iteration has run
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    del state, src, tgt, metrics
    return peak


def run_fit(w: int, h: int, net: str, num_k: int, batches: List[int], hbm_gb: float,
            device="cuda") -> Dict[str, dict]:
    rows = {}
    for b in batches:
        try:
            peak = _one_iteration(_config(w, h, b, net, num_k), torch.device(device))
            row = {"peak_gb": peak / GB, "fits": peak < hbm_gb * GB}
        except torch.cuda.OutOfMemoryError as e:
            row = {"fits": False, "error": str(e).splitlines()[0][:160]}
        rows[f"batch={b}"] = row
        print(json.dumps({f"{w}x{h} {net} batch={b}": row}), flush=True)
    return rows


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spatial_rank(rank: int, space: int, port: int, w: int, h: int, net: str, num_k: int,
                  out_dir: str) -> None:
    from mcseg_tpu_torch.parallel import multihost

    cards = torch.cuda.device_count()
    device = f"cuda:{rank % cards}"
    dp = multihost.initialize(f"127.0.0.1:{port}", space, rank, device,
                              backend="gloo" if cards < space else "nccl", spatial=space)
    try:
        peak = _one_iteration(_config(w, h, 1, net, num_k), dp.device, dp)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"peak_gb": peak / GB, "backend": torch.distributed.get_backend()}, f)
    finally:
        multihost.shutdown()


def run_spatial(w: int, h: int, n_devices: int, net: str, num_k: int) -> Dict[str, dict]:
    rows = {}
    s = 1
    while s <= n_devices:
        check_spatial(net, h, s)
        with tempfile.TemporaryDirectory() as tmp:
            torch.multiprocessing.spawn(_spatial_rank,
                                        args=(s, _free_port(), w, h, net, num_k, tmp),
                                        nprocs=s)
            ranks = []
            for r in range(s):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        rows[f"spatial={s}"] = {
            "layout": f"1x{s} data-x-space", "global_batch": 1,
            "image_rows_per_rank": h // s, "backend": ranks[0]["backend"],
            "peak_gb_per_rank": [r["peak_gb"] for r in ranks]}
        print(json.dumps({f"{w}x{h} {net} spatial={s}": rows[f"spatial={s}"]}), flush=True)
        s *= 2
    return rows


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    p = argparse.ArgumentParser("spatial_memory_table")
    p.add_argument("--mode", choices=("spatial", "fit"), default="spatial")
    p.add_argument("--img_shape", default="2048x1024", help="WxH geometry")
    p.add_argument("--net", default="drn_d_38")
    p.add_argument("--num_k", type=int, default=1)
    p.add_argument("--n_devices", type=int, default=4,
                   help="spatial mode: the largest extent (ranks of the last row)")
    p.add_argument("--batches", default="8,16,24,32,48,64",
                   help="fit mode: batches to sweep")
    p.add_argument("--hbm_gb", type=float, default=80.0,
                   help="fit mode: the card's memory in GB (H100: 80)")
    a = p.parse_args(argv)
    resolve_device("cuda")  # the card's memory is what it reads: no CPU run
    w, h = (int(v) for v in a.img_shape.lower().split("x"))
    if a.mode == "spatial":
        return run_spatial(w, h, a.n_devices, a.net, a.num_k)
    return run_fit(w, h, a.net, a.num_k, [int(x) for x in a.batches.split(",")], a.hbm_gb)


if __name__ == "__main__":
    main()
