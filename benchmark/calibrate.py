"""The readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--witness-seeds 1] [--out readings.jsonl]

For each seed of ``--seeds`` one process sets the cell up as a run does
(the program's first iterations, or its warm-up and then one request for
each of the pool's) and prints the numbers of the program against the
reference: the lower readings. For each seed of ``--control-seeds`` it also
prints the numbers of the reference put in the program's place in float8
(``reference/quant.py``): every tensor (``control_fp8``, the control) and
only the convolutions (``control_fp8_conv``); the control's inputs are its
stacks rounded to e4m3. For a serving cell it adds two faults planted in
the program's answers: a 16x16 block of every class map, off the grid of
``tile_gap``'s tiles, shifted by one class (``fault_altered_answer``) and the first half of a request's images
answered for all of it (``fault_half_answers``). For a training cell it
adds two faults planted in the reference in the program's place, with the
reference's own inputs: half of every batch left out, the mean taken over
the rest (``fault_half_batch``), and BatchNorm's running statistics
advanced at twice their momentum (``fault_bn_momentum``). Those are the
upper readings.
For each seed of ``--witness-seeds`` (a training cell) it prints the
program computed in float32 with TF32 off, a second witness of the
reference. A state left unchanged reads 1 by the gap of norms of the
change and needs no run. One JSON line per seed and side, with each leaf's
readings under ``_per_leaf`` and the seed's peak of card memory, the
reference's included, under ``peak_bytes``.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.reference.drn import BN, set_precision  # noqa: E402
from benchmark.reference.quant import FP8, FP8_CONV, e4m3  # noqa: E402


def _double_bn_momentum(modules):
    for m in modules:
        for sub in m.modules():
            if isinstance(sub, BN):
                sub.momentum = 2 * sub.momentum


def _fp8(precision):
    return lambda modules: set_precision(modules, **precision)


def _per_leaf(r, side, ref):
    """Each leaf's readings of ``side`` against ``ref``: the first
    gradient's gap of norms and difference; a running statistic's
    difference of its change after step A."""
    from benchmark.lib import check

    grads = ref["grads"]
    gap, diff = (f(side["grads"], grads, grads) for f in (check.leaf_gaps, check.leaf_diffs))
    out = {k: [round(gap[k], 6), round(diff[k], 6)] for k in grads}
    p0 = {f"{n}.{k}": v for n, sd in r.params.items() for k, v in sd.items()}
    stats = list(ref["stats_a"])
    change = check.leaf_diffs({k: side["stats_a"][k] - p0[k] for k in stats},
                              {k: ref["stats_a"][k] - p0[k] for k in stats}, stats)
    out.update({k: round(change[k], 6) for k in stats})
    return out


def _train_seed(r, control: bool, witness: bool = False):
    from benchmark.reference import float32_exact

    r.setup()
    r.free()
    ref = r.reference()

    def row(name, side):
        return name, {**r.numbers(side, ref), "_per_leaf": _per_leaf(r, side, ref)}

    rows = [row("program", r.program_side())]
    if witness:  # the program in float32 with TF32 off, the same weights and inputs
        config = copy.deepcopy(r.config)
        config["model"]["dtype"] = "float32"
        w = type(r)(config, r.traffic, r.seed, r.device)
        with float32_exact():
            w.setup()
        w.free()
        rows.append(row("program_float32", w.program_side()))
        del w
    if control:
        for side, kw in (("control_fp8", {"alter": _fp8(FP8)}),
                         ("control_fp8_conv", {"alter": _fp8(FP8_CONV)})):
            s = r.reference(**kw)
            s["inputs"] = [(e4m3(xs), ys, e4m3(xt)) for xs, ys, xt in s["inputs"]]
            rows.append(row(side, s))
        for side, kw in (("fault_half_batch", {"rows": r.batch // 2}),
                         ("fault_bn_momentum", {"alter": _double_bn_momentum})):
            s = r.reference(**kw)
            s["inputs"] = ref["inputs"]
            rows.append(row(side, s))
    return rows


def _serve_seed(r, control: bool, requests: int):
    import numpy as np
    import torch

    r.setup()
    answers = [(i, r.request(i)) for i in range(requests)]
    r.free()
    mods = r._reference_models()
    rows = [("program", r.numbers(answers, mods))]
    if control:
        for side, precision in (("control_fp8", FP8), ("control_fp8_conv", FP8_CONV)):
            low = r._reference_models(precision)
            rows.append((side, r.numbers(
                answers, mods, served=lambda i: r.reference_logits(i, low).argmax(1))))
            del low
        n_class = r.model["n_class"]
        altered = []
        for i, pred in answers:
            pred = pred.copy()
            r0, c0 = min(203, pred.shape[1] - 16), min(301, pred.shape[2] - 16)
            block = pred[:, r0:r0 + 16, c0:c0 + 16]  # off the tiles' grid at full size
            block[...] = (block + 1) % n_class
            altered.append((i, pred))
        half = [(i, np.concatenate([pred[: len(pred) // 2]] * 2)) for i, pred in answers]
        rows += [("fault_altered_answer", r.numbers(altered, mods)),
                 ("fault_half_answers", r.numbers(half, mods))]
    del mods
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser("benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from benchmark.lib import spec as specs

    spec = specs.benchmark_json()
    cell = specs.cell(spec, args.workload)
    config, traffic = specs.config(cell["config"]), specs.traffic(cell["traffic"])
    driver = specs.driver(traffic["kind"])
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    witnesses = {int(s) for s in args.witness_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted((controls | witnesses) - set(seeds))
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            t0 = time.perf_counter()
            r = driver.Run(config, traffic, seed)
            if traffic["kind"] == "train":
                rows = _train_seed(r, seed in controls, seed in witnesses)
            else:
                rows = _serve_seed(r, seed in controls, traffic["pool"])
            del r
            peak = 0
            if torch.cuda.is_available():
                peak = torch.cuda.max_memory_allocated()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            for side, numbers in rows:
                line = json.dumps({"cell": cell["name"], "seed": seed, "side": side,
                                   "seconds": time.perf_counter() - t0, "peak_bytes": peak,
                                   **numbers})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
