"""A tiny checkout of the benchmark for the CPU tests: a copy of
``benchmark/`` (without its tests) beside a link to the program, with its
own ``BENCHMARK.json``, configurations, traffic and limits at a size a CPU
runs in seconds: DRN-D-22 (BasicBlock) on RGB+HHA and DRN-D-54
(Bottleneck) on RGB, batch 2 at 48x64, float32 unless asked."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TRAIN_CELL, SERVE_CELL, RGB_CELL = "tiny_d22.train", "tiny_d22.serve", "tiny_d54_rgb.train"


def _read(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def tiny_config(name: str, dtype: str = "float32") -> Dict:
    if name == "tiny_d22":
        c = _read("configs", "drn_d_38_rgbhha.json")
        c["model"]["layers"], c["program"]["net"] = [1, 1, 2, 2, 2, 2, 1, 1], "drn_d_22"
    else:
        c = _read("configs", "drn_d_105_rgb.json")
        c["model"]["layers"], c["program"]["net"] = [1, 1, 3, 4, 6, 3, 1, 1], "drn_d_54"
    c["name"], c["model"]["dtype"] = name, dtype
    return c


def tiny_traffic(name: str) -> Dict:
    t = _read("traffic", name)
    t["batch"] = 2
    t["pool"] = 3
    t["scene"].update(width=64, height=48)
    return t


def make_checkout(root: str, dtype: str = "float32") -> str:
    """A checkout under ``root``; returns its path."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    os.symlink(os.path.join(REPO, "mcseg_tpu_torch"), os.path.join(root, "mcseg_tpu_torch"))
    spec = _read("..", "BENCHMARK.json")
    cells = [(TRAIN_CELL, "tiny_d22", "mcd_train_b24_640x480", "drn_d_38_rgbhha.train_b24"),
             (SERVE_CELL, "tiny_d22", "serve_b8_closed", "drn_d_38_rgbhha.serve_b8"),
             (RGB_CELL, "tiny_d54_rgb", "mcd_train_b16_1024x512",
              "drn_d_105_rgb.train_1024x512_b16")]
    spec["workloads"] = []
    entries = {c["name"]: c for c in spec["configs"]}
    spec["configs"] = [
        {**entries["drn_d_38_rgbhha"], "name": "tiny_d22",
         "file": "benchmark/configs/tiny_d22.json"},
        {**entries["drn_d_105_rgb"], "name": "tiny_d54_rgb",
         "file": "benchmark/configs/tiny_d54_rgb.json"}]
    for cell, config, traffic, real in cells:
        spec["workloads"].append({"name": cell, "config": config, "traffic": f"tiny_{traffic}",
                                  "chips": 1, "why": f"a tiny {real}"})
        # the cell's own numbers, at a tenth of its limits: the program in
        # float32 at this size reads them near zero
        limits = _read("limits", f"{real}.json")["limits"]
        with open(os.path.join(root, "benchmark", "limits", f"{cell}.json"), "w") as f:
            json.dump({"limits": {k: v / 10 for k, v in limits.items()}}, f)
        with open(os.path.join(root, "benchmark", "traffic", f"tiny_{traffic}.json"), "w") as f:
            json.dump(tiny_traffic(f"{traffic}.json"), f)
    for config in ("tiny_d22", "tiny_d54_rgb"):
        with open(os.path.join(root, "benchmark", "configs", f"{config}.json"), "w") as f:
            json.dump(tiny_config(config, dtype), f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kinds = {"train": [TRAIN_CELL, RGB_CELL], "serve": [SERVE_CELL]}
            m["workloads"] = kinds["serve" if "serve" in m["name"] else "train"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


RUNNER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
from benchmark import run
fault, device = sys.argv[2], sys.argv[3]
argv = sys.argv[4:]

def unchanged(iterate):  # the step runs and its state is put back
    def wrapped(state, src, tgt, mark=None):
        saved = {n: {k: v.clone() for k, v in m.state_dict().items()}
                 for n, m in state.modules().items()}
        out = iterate(state, src, tgt, mark)
        for n, m in state.modules().items():
            m.load_state_dict(saved[n])
        return out
    return wrapped

def half_batch(iterate):  # the step sees the first half of every batch
    def wrapped(state, src, tgt, mark=None):
        cut = lambda b: {k: v[: v.shape[0] // 2] for k, v in b.items()}
        return iterate(state, cut(src), cut(tgt), mark)
    return wrapped

def altered_answer(serve):  # a block of every class map is shifted by one class
    def wrapped(batch):
        pred = serve(batch).clone()
        pred[:, :16, :16] = (pred[:, :16, :16] + 1) % 40
        return pred
    return wrapped

def half_answers(serve):  # the first half of a request answered for all of it
    def wrapped(batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        pred = serve(half)
        return torch.cat([pred, pred])[: batch["image"].shape[0]]
    return wrapped

if fault in ("altered_step", "altered_labels"):  # the preprocess's outputs altered
    from mcseg_tpu_torch.train import loops
    make_pp = loops.make_train_preprocess

    def make_altered(*a, **kw):
        pp = make_pp(*a, **kw)
        def altered(*b):
            img, label, *rest = pp(*b)
            if fault == "altered_step":
                img = img.clone()
                img[:, :8, :8, 0] += 0.5
            elif label is not None:
                label = label.clone()
                label[:, :4, :4] = (label[:, :4, :4] + 1) % 40
            return (img, label, *rest)
        return altered
    loops.make_train_preprocess = make_altered

wrap = {"none": None, "unchanged": unchanged, "half_batch": half_batch,
        "altered_answer": altered_answer, "half_answers": half_answers,
        "altered_step": None, "altered_labels": None}[fault]
out = run.run(argv, device=device, wrap=wrap)
print(json.dumps(out))
"""


def run_cell(checkout: str, cell: str, fault: str = "none", seed: int = 3,
            trace: int = 0, device: str = "cpu") -> Dict:
    """One run of ``cell`` on the CPU (or ``device``) from ``checkout``, with
    ``fault`` planted under the timed path; the result line's object."""
    argv: List[str] = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                       "--trace", str(trace)]
    proc = subprocess.run([sys.executable, "-c", RUNNER, checkout, fault, device, *argv],
                          capture_output=True, text=True, timeout=600, cwd=checkout)
    if proc.returncode != 0:
        raise AssertionError(f"run failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
