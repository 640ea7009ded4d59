"""Summarize a training run directory (the JAX package's
``tools/summarize_run.py``).

    python -m mcseg_tpu_torch.tools.summarize_run runs/suncg2nyu

Reads the run's ``args.json`` and ``train_log.jsonl`` (``utils/logging.py``)
and prints: the config essentials, the loss trajectory (first / min / last
per metric), throughput, the lr, the epoch-end eval history, the
checkpoints (the port's ``*.pt``, and JAX ``*.msgpack`` where they sit
beside them) and the ``--resume <dir>/last`` hint.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_jsonl(path: str):
    """Parse a JSONL log, skipping a torn line: a run killed mid-write is
    the run this tool reports on, and it must still print the resume
    hint."""
    rows = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                print(f"  (skipping unparseable log line {ln} — torn write?)")
    return rows


def _checkpoint_lines(run_dir: str):
    files = sorted(glob.glob(os.path.join(run_dir, "*.pt"))
                   + glob.glob(os.path.join(run_dir, "*.msgpack")))
    if not files:
        return []
    names = [os.path.basename(c) for c in files]
    sizes = sum(os.path.getsize(c) for c in files) / 1e6
    out = [f"checkpoints: {', '.join(names)}  ({sizes:.0f} MB total)"]
    last = os.path.join(run_dir, "last")
    if os.path.exists(last + ".pt") or os.path.exists(last + ".msgpack"):
        out.append(f"resume with: --resume {last}")
    return out


def summarize(run_dir: str) -> str:
    out = [f"run: {run_dir}"]
    args_path = os.path.join(run_dir, "args.json")
    if os.path.exists(args_path):
        with open(args_path) as f:
            a = json.load(f)
        model = a.get("model", {})
        data = a.get("data", {})
        train = a.get("train", {})
        out.append(
            "config: net={} input_ch={} n_class={} fusion={} | {}→{} "
            "{}x{} batch={} | {} lr={} num_k={} epochs={}".format(
                model.get("net"), model.get("input_ch"), model.get("n_class"),
                model.get("fusion"), data.get("src_dataset"),
                data.get("tgt_dataset"), *data.get("train_img_shape", ["?", "?"]),
                data.get("batch_size"), train.get("opt"), train.get("lr"),
                train.get("num_k"), train.get("epochs")))
    log_path = os.path.join(run_dir, "train_log.jsonl")
    if os.path.exists(log_path):
        rows = load_jsonl(log_path)
        steps = [r for r in rows if "step" in r and "val_miou" not in r]
        evals = [r for r in rows if "val_miou" in r]
        if steps:
            out.append(f"steps logged: {len(steps)} "
                       f"(step {steps[0]['step']} → {steps[-1]['step']})")
            metrics = [k for k in steps[-1] if k not in ("step", "lr", "img_per_sec")]
            for m in sorted(metrics):
                vals = [r[m] for r in steps if m in r]
                out.append(f"  {m:<14} first={vals[0]:<10.4g} "
                           f"min={min(vals):<10.4g} last={vals[-1]:.4g}")
            rates = [r["img_per_sec"] for r in steps if r.get("img_per_sec")]
            if rates:
                out.append(f"  throughput     last={rates[-1]:.1f} img/s "
                           f"(peak {max(rates):.1f})")
            lrs = [r["lr"] for r in steps if "lr" in r]
            if lrs:
                out.append(f"  lr             {lrs[0]:.3g} → {lrs[-1]:.3g}")
        if evals:
            traj = "  ".join(f"ep{r.get('epoch', '?')}:{r['val_miou']:.2f}" for r in evals)
            out.append(f"epoch-end val mIoU: {traj}")
    else:
        out.append("no train_log.jsonl")
    out += _checkpoint_lines(run_dir)
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser("summarize_run", description="Report on a training run dir")
    p.add_argument("run_dir")
    args = p.parse_args(argv)
    report = summarize(args.run_dir)
    print(report)
    return report


if __name__ == "__main__":
    main()
