"""Adapted-checkpoint evaluation entry point (reference: adapt_tester.py).

Rebuilds the model from the config stored beside the checkpoint, averages
the two classifiers unless ``--f1_only``, and prints the per-class IoU
table; ``--outdir`` also writes label and colour PNGs of every prediction
(and, with ``--saves_prob``, its float16 softmax), ``--submit_dir`` the
Cityscapes submission dumps. ``--all_devices`` scores on every visible
card of this process, each batch's rows split across them.

    python -m mcseg_tpu_torch.cli.adapt_test runs/run0/last nyu
"""

import dataclasses

import torch

from mcseg_tpu_torch.cli.argparse_compat import get_testing_parser
from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.data.datasets import get_dataset
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.utils.checkpoint import load_params


def main(argv=None, average_classifiers=None, device="cuda"):
    """Score a checkpoint on ``device``; returns the mIoU.
    ``average_classifiers``: None resolves from the flags — averaging F1
    and F2 unless --f1_only; source_test passes False, and --use_f2 opts
    back in."""
    args = get_testing_parser("adapt_test").parse_args(argv)
    dev = resolve_device(device)
    if average_classifiers is None:
        average_classifiers = not args.f1_only
    if args.use_f2:
        average_classifiers = True
    params, cfg = load_params(args.checkpoint)
    overrides = {}
    if args.tgt_dataset:
        overrides["tgt_dataset"] = args.tgt_dataset
    if args.data_root:
        overrides["data_root"] = args.data_root
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.test_img_shape:
        overrides["test_img_shape"] = tuple(args.test_img_shape)
    if args.max_samples:
        overrides["max_samples"] = args.max_samples
    if overrides:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **overrides))
    dataset = get_dataset(cfg.data.tgt_dataset, cfg.data, args.split)
    devices = None
    if args.all_devices:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    miou, _, _ = evaluate(params, cfg, dataset, device=dev,
                          average_classifiers=average_classifiers,
                          submit_dir=args.submit_dir, save_dir=args.outdir,
                          saves_prob=args.saves_prob, devices=devices)
    return miou


if __name__ == "__main__":
    main()
