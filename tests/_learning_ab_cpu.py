"""The adaptation A/B's three arms on the CPU, through either package, for
reading beside ``chip_smoke.py`` phase ``learning`` (a) on the card:

    python tests/_learning_ab_cpu.py jax [arm ...]
    python tests/_learning_ab_cpu.py port [arm ...] [--threads 3]

``jax`` trains with the JAX package's loops at its slow guard's config
(``tests/test_adaptation_gain.py _cfg``), on 8 virtual CPU devices as its
tests do; ``port`` trains with the port's loops at ``chip_smoke._ab_config``
(the same harness), on ``--threads`` torch threads (the readings depend on
the count). Arms: ``source`` (scored with F1 alone), ``one_classifier``,
``mcd``; 400 iterations each, the 32 ``synthetic_shifted`` val images
scored at it=100, 200 and 400. Prints a JSON line per eval (mIoU, pixel
accuracy, seconds) and per adapting arm its logged ``loss_dis``. Run
directories go under a temporary directory, removed after each arm. Not a
test module: pytest does not collect it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
EVALS = (100, 200, 400)
PER_EPOCH = 4  # 32 samples at batch 8


def _jax_arm(arm, out_dir):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from mcseg_tpu.data.datasets import get_dataset
    from mcseg_tpu.eval.metrics import pixel_accuracy
    from mcseg_tpu.eval.tester import evaluate
    from mcseg_tpu.train.loops import train_adapt, train_source
    from mcseg_tpu.utils.compile_cache import enable_persistent_cache
    from mcseg_tpu.utils.logging import JsonlLogger
    from test_adaptation_gain import _cfg

    enable_persistent_cache()
    cfg = _cfg(out_dir, one_classifier=arm == "one_classifier")
    log = JsonlLogger(os.path.join(out_dir, "train_log.jsonl"), echo=False)

    def score(state):
        miou, hist, _ = evaluate(state, cfg, get_dataset("synthetic_shifted", cfg.data, "val"),
                                 average_classifiers=arm != "source", max_batches=4,
                                 print_table=False)
        return float(miou), float(pixel_accuracy(hist))

    return cfg, log, score, train_source if arm == "source" else train_adapt, {}


def _port_arm(arm, out_dir, threads):
    import torch

    torch.set_num_threads(threads)
    from chip_smoke import _ab_config
    from mcseg_tpu_torch.data.datasets import get_dataset
    from mcseg_tpu_torch.eval.metrics import pixel_accuracy
    from mcseg_tpu_torch.eval.tester import evaluate
    from mcseg_tpu_torch.train.loops import train_adapt, train_source
    from mcseg_tpu_torch.utils.logging import JsonlLogger

    cfg = _ab_config(out_dir, arm)
    log = JsonlLogger(os.path.join(out_dir, "train_log.jsonl"), echo=False)

    def score(state):
        miou, hist, _ = evaluate(state.params(), cfg,
                                 get_dataset("synthetic_shifted", cfg.data, "val"),
                                 average_classifiers=arm != "source", max_batches=4,
                                 print_table=False, device="cpu")
        return float(miou), pixel_accuracy(hist)

    return cfg, log, score, train_source if arm == "source" else train_adapt, {"device": "cpu"}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("side", choices=["jax", "port"])
    p.add_argument("arms", nargs="*", default=["source", "one_classifier", "mcd"])
    p.add_argument("--threads", type=int, default=3, help="torch threads (port)")
    args = p.parse_args(argv)
    sys.path[:0] = [os.path.dirname(HERE), HERE]  # the packages and chip_smoke; the tests
    for arm in args.arms:
        out_dir = tempfile.mkdtemp(prefix=f"learning_ab_{args.side}_{arm}_")
        try:
            cfg, log, score, trainer, kw = (
                _jax_arm(arm, out_dir) if args.side == "jax"
                else _port_arm(arm, out_dir, args.threads))
            t0 = time.time()

            def on_epoch_end(epoch, state):
                if epoch * PER_EPOCH in EVALS:
                    miou, acc = score(state)
                    print(json.dumps({"side": f"{args.side}-cpu", "arm": arm,
                                      "iteration": epoch * PER_EPOCH, "miou": miou,
                                      "pixel_acc": acc, "seconds": time.time() - t0}),
                          flush=True)

            trainer(cfg, logger=log, max_iterations=EVALS[-1], on_epoch_end=on_epoch_end, **kw)
            log.close()
            with open(log.path) as f:
                dis = [r["loss_dis"] for r in map(json.loads, f) if "loss_dis" in r]
            if dis:
                print(json.dumps({"side": f"{args.side}-cpu", "arm": arm, "loss_dis": dis}),
                      flush=True)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
