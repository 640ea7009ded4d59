"""Profile the MCD train iteration and print its time grouped by category.

The port of the JAX package's ``tools/profile_step.py``, with its flags
and its inputs: one full iteration (train preprocess of a source and a
target batch, which launches the normalize kernel once each, then steps A,
B and C x ``--num_k``) of ``--net`` at ``--input_ch``, 40 classes, bf16,
on raw planes from ``np.random.RandomState`` (uint8 RGB, NYU-range labels,
depth 0.5-3.5 m), suncg -> nyu. It times ``--steps`` iterations after one
warm-up (``utils.profiler.time_step``), then records ``--steps`` more under
``torch.profiler`` (``utils.profiler.trace``, a Chrome/Perfetto trace in
``--trace_dir``) and prints their time per step by category, then the top
rows with their calls per step, then the program's spans (``train.iteration``,
``train.preprocess``, ``train.draws``, ``hha``, ``mcd.step_a``/``b``/``c``,
``upsample`` and ``upsample.backward``, ``host_wait``; ``utils.profiler``)
with their calls, host ms and device ms per step, and its counters per step
(``h2d_bytes``, ``h2d_blocking``: the host-to-card copies and those the host
waits for). It refuses to print a span table that the store's bound cut.

On the card the rows are the device's (kernels, copies and sets, each by
its self device time); on the CPU (``main(argv, device="cpu")``) they are
the host operators by their self CPU time. ``summarize`` groups either: the
normalize kernel, collectives, batch norm, convolutions, copies, and
everything else as "other", so the categories add up to the total. The
spans' ``record_function`` ranges are no rows there.

    python -m mcseg_tpu_torch.tools.profile_step --batch 24 --steps 3
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from mcseg_tpu_torch.core.device import resolve_device

# (category, substrings of a lower-cased row name), matched in this order:
# cuDNN's BN kernels are "cudnn::bn_*", its conv kernels "*xmma*fprop*",
# "*implicit_gemm*", "*grouped_direct*", "*wgrad*"/"*dgrad*"
CATEGORIES = (
    ("normalize_stack", ("normalize_stack",)),
    ("collectives", ("nccl", "gloo", "all_reduce", "allreduce", "broadcast", "c10d")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("conv", ("conv", "cudnn", "xmma", "cutlass", "gemm", "wgrad", "dgrad", "fprop")),
    ("copies", ("copy", "memcpy", "memset")),
)
OTHER = "other"


def category(name: str) -> str:
    """The category of a profiler row named ``name``."""
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return OTHER


def profile_rows(prof) -> Tuple[List[Dict], bool]:
    """The rows of ``prof.key_averages()`` that carry time, by time
    descending, and whether they are the device's: where the profile holds
    device rows (on the card), the device's rows with their self device
    time (an operator's own row would repeat its kernels' time), else the
    host operators with their self CPU time; the spans' ranges are left out.
    Each row: ``name``, ``ms`` and ``calls`` (totals over the profile)."""
    avgs = [r for r in prof.key_averages() if not getattr(r, "is_user_annotation", False)]
    cuda = torch.autograd.DeviceType.CUDA
    rows = [{"name": r.key, "ms": r.self_device_time_total / 1e3, "calls": r.count}
            for r in avgs if r.device_type == cuda and r.self_device_time_total > 0]
    on_device = bool(rows)
    if not on_device:
        rows = [{"name": r.key, "ms": r.self_cpu_time_total / 1e3, "calls": r.count}
                for r in avgs if r.device_type != cuda and r.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: r["ms"], reverse=True), on_device


def summarize(prof, steps: int = 1, top: int = 25) -> Dict:
    """The time of ``steps`` profiled steps by category (``CATEGORIES``,
    then "other"), per step: ``time`` ("device" or "cpu_self"),
    ``total_ms``, ``categories`` {name: {ms, share, calls}} whose ms add up
    to ``total_ms``, ``top`` (the ``top`` longest rows, ms and calls per
    step) and ``rows`` (every row, totals over the profile)."""
    rows, on_device = profile_rows(prof)
    total = sum(r["ms"] for r in rows)
    cats = {c: {"ms": 0.0, "calls": 0} for c, _ in CATEGORIES + ((OTHER, ()),)}
    for r in rows:
        c = cats[category(r["name"])]
        c["ms"] += r["ms"]
        c["calls"] += r["calls"]
    return {
        "time": "device" if on_device else "cpu_self", "steps": steps,
        "total_ms": total / steps,
        "categories": {k: {"ms": v["ms"] / steps, "share": v["ms"] / total if total else 0.0,
                           "calls": v["calls"] / steps} for k, v in cats.items()},
        "top": [{"name": r["name"], "ms": r["ms"] / steps, "calls": r["calls"] / steps}
                for r in rows[:top]],
        "rows": rows}


def format_summary(summary: Dict) -> str:
    """``summarize``'s result as the tool prints it."""
    kind = "device" if summary["time"] == "device" else "CPU self"
    out = [f"{summary['total_ms']:.2f} ms/step {kind} time over {summary['steps']} step(s)"]
    for name, c in summary["categories"].items():
        out.append(f"  CAT {c['ms']:10.2f} ms/step {100 * c['share']:6.2f}%  "
                   f"x{c['calls']:<8g} {name}")
    out.append("  --- top ops ---")
    for r in summary["top"]:
        out.append(f"  {r['ms']:10.2f} ms/step x{r['calls']:<6g} {r['name'][:120]}")
    return "\n".join(out)


def span_table(records: List[Dict], steps: int = 1) -> Dict:
    """``utils.profiler.span_records`` of ``steps`` steps, per step:
    ``spans`` {name: {calls, host_ms, device_ms}} in the order each name
    first opened (a backward span as ``<name>.backward``; ``device_ms``
    None off the card) and ``counters`` {name: total}."""
    spans: Dict[str, Dict] = {}
    counters: Dict[str, float] = {}
    for r in records:
        if r["kind"] == "count":
            counters[r["name"]] = counters.get(r["name"], 0) + r["count"] / steps
            continue
        row = spans.setdefault(r["name"] + (".backward" if r["backward"] else ""),
                               {"calls": 0.0, "host_ms": 0.0, "device_ms": None})
        row["calls"] += 1 / steps
        row["host_ms"] += r["host_ms"] / steps
        if r["device_ms"] is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + r["device_ms"] / steps
    return {"spans": spans, "counters": counters}


def format_spans(table: Dict) -> str:
    """``span_table``'s result as the tool prints it."""
    out = ["  --- spans (per step) ---"]
    for name, s in table["spans"].items():
        dev = "-" if s["device_ms"] is None else f"{s['device_ms']:.2f}"
        out.append(f"  SPAN x{s['calls']:<6g} host {s['host_ms']:10.2f} ms  device "
                   f"{dev:>10} ms  {name}")
    for name, v in table["counters"].items():
        out.append(f"  COUNT {v:<14g} {name}")
    return "\n".join(out)


def _raw(b: int, h: int, w: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The JAX tool's raw batch: uint8 RGB, labels 0-40, depth 0.5-3.5 m."""
    r = np.random.RandomState(seed)
    return {k: torch.from_numpy(v).to(device) for k, v in {
        "image": r.randint(0, 255, (b, h, w, 3)).astype(np.uint8),
        "label": r.randint(0, 41, (b, h, w)).astype(np.uint8),
        "depth": r.rand(b, h, w).astype(np.float32) * 3 + 0.5}.items()}


def main(argv=None, device="cuda") -> Dict:
    p = argparse.ArgumentParser("profile_step")
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--net", default="drn_d_38")
    p.add_argument("--input_ch", type=int, default=6)
    p.add_argument("--num_k", type=int, default=4)
    p.add_argument("--img", type=int, nargs=2, default=[640, 480], metavar=("W", "H"))
    p.add_argument("--trace_dir", default=os.path.join(tempfile.gettempdir(), "mcseg_profile"))
    p.add_argument("--top", type=int, default=25,
                   help="rows in the top-ops table")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils.profiler import (
        dropped_spans, reset_spans, span_records, time_step, trace)

    b = args.batch
    w, h = args.img
    cfg = ExperimentConfig(
        model=ModelConfig(net=args.net, input_ch=args.input_ch, n_class=40, dtype="bfloat16"),
        data=DataConfig(src_dataset="suncg", tgt_dataset="nyu", batch_size=b,
                        train_img_shape=(w, h), input_ch=args.input_ch),
        train=TrainConfig(lr=1e-3, num_k=args.num_k, max_steps=100_000))
    state = create_train_state(cfg.model, cfg.train, 0, dev)
    iterate = make_adapt_iteration(cfg)
    src, tgt = _raw(b, h, w, 0, dev), _raw(b, h, w, 1, dev)

    timing = time_step(iterate, state, src, tgt, iters=args.steps, items_per_call=2 * b)
    print(f"timed: {timing['sec_per_iter'] * 1e3:.2f} ms/step, "
          f"{timing['items_per_sec']:.2f} images/s ({args.net}, input_ch {args.input_ch}, "
          f"batch {b} x 2, {w}x{h}, num_k {args.num_k}, on {dev}; "
          f"{args.steps} steps after 1 warm-up)", flush=True)

    shutil.rmtree(args.trace_dir, ignore_errors=True)
    reset_spans()
    with trace(args.trace_dir) as prof:
        for _ in range(args.steps):
            m = iterate(state, src, tgt)
        loss = float(m["loss_source"])  # waits for the card
    print("traced; loss_source =", loss, flush=True)
    summary = summarize(prof, args.steps, top=args.top)
    if dropped_spans():
        raise RuntimeError(f"{dropped_spans()} span records past the store's bound: "
                           "the span table would be short; profile fewer --steps")
    spans = span_table(span_records(), args.steps)
    reset_spans()
    print(format_summary(summary), flush=True)
    print(format_spans(spans), flush=True)
    return {"ms_per_step": timing["sec_per_iter"] * 1e3,
            "images_per_s": timing["items_per_sec"], "loss_source": loss,
            "trace": os.path.join(args.trace_dir, "trace.json"), **summary, **spans}


if __name__ == "__main__":
    main()
