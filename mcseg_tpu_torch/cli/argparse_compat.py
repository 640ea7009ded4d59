"""Reference-compatible argparse front end.

The port's copy of the JAX package's ``cli/argparse_compat.py``: the same
parsers, flag names, defaults and choices (``--net``, ``--input_ch``,
``--num_k``, ``--lr``, ``--opt``, ``--train_img_shape`` ... and the
src/tgt positionals), so that a reference command line translates 1:1,
plus ``fix_img_shape_args`` and ``args_to_config``.

Every flag parses. ``--s2d`` only chooses how the JAX package lays out the
same computation: the port keeps it in the config sidecar and does not act
on it. ``--multihost`` / ``--coordinator`` / ``--num_processes`` /
``--process_id`` make a training command one rank of a data-parallel job
(``parallel/multihost.py``), ``--spatial_devices`` splits the rows of its
activations over that many of the ranks (``parallel/spatial.py``), and
``--all_devices`` scores on every card of the process. ``reject_unported``
refuses, before anything runs, a ``--spatial_devices`` layout whose row
blocks do not divide the train height at every level of the trunk
(``ValueError``: a multiple of 8 x the blocks for DRN and PSPNet, of 32 x
the blocks for FCN8s).
"""

from __future__ import annotations

import argparse
from typing import Sequence

from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.data.labels import get_label_spec
from mcseg_tpu_torch.parallel.spatial import check_spatial


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--net", default="drn_d_38",
                   help="drn_d_22|38|54|105, drn_c_26|42, fcn8s_vgg16, psp")
    p.add_argument("--input_ch", type=int, default=3, choices=[1, 3, 4, 6, 7],
                   help="1 depth | 3 rgb/hha | 4 rgb+(depth|ir|boundary) | "
                        "6 rgb+hha | 7 rgb+hha+boundary")
    p.add_argument("--n_class", type=int, default=None,
                   help="default: label space of the (target) dataset")
    p.add_argument("--fusion", default="single", choices=["single", "early", "late"])
    p.add_argument("--uses_one_classifier", action="store_true")
    p.add_argument("--upsample", default="convt", choices=["resize", "convt"])
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--s2d", default="auto", choices=["auto", "on", "off"],
                   help="JAX-package layout option; kept in the config, "
                        "no effect in the port")


def _add_train_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--opt", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=2e-5)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr_schedule", default="poly", choices=["poly", "constant", "step"])
    p.add_argument("--max_steps", type=int, default=50_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", default="", help="checkpoint prefix to resume from")
    p.add_argument("--tb_dir", default="",
                   help="TensorBoard scalars of the run log (needs tensorboard)")
    p.add_argument("--out_dir", default="./runs/run0")
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--checkpoint_every_epochs", type=int, default=1)
    p.add_argument("--max_hours", type=float, default=0.0,
                   help="wall-clock budget; exceeded -> graceful stop with a "
                        "final resumable checkpoint (0 = unbounded)")
    p.add_argument("--keep_checkpoints", type=int, default=0,
                   help="retain only the newest N epoch checkpoints "
                        "(0 = keep all; 'last' is never pruned)")
    p.add_argument("--spatial_devices", type=int, default=1,
                   help="split activation rows over this many ranks of the job "
                        "(must divide the ranks; the train height a multiple of 8x "
                        "it, 32x for FCN8s)")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a data-parallel job launched by torchrun "
                        "(env://), one process per card")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 for a job launched without torchrun")
    p.add_argument("--num_processes", type=int, default=None,
                   help="ranks of the job (with --coordinator)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (with --coordinator)")
    p.add_argument("--sync_checkpoint", action="store_true",
                   help="write epoch checkpoints on the training thread "
                        "(default: copied to host memory, written in the "
                        "background)")
    p.add_argument("--eval_every_epochs", type=int, default=0,
                   help="score the target val split at epoch ends (0 = off)")


def _add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data_root", default="./data")
    p.add_argument("--train_img_shape", type=int, nargs=2, default=[640, 480],
                   metavar=("W", "H"))
    p.add_argument("--test_img_shape", type=int, nargs=2, default=None,
                   metavar=("W", "H"))
    p.add_argument("--split", default="train")
    p.add_argument("--max_samples", type=int, default=None,
                   help="mini-split truncation (smoke tests)")
    p.add_argument("--domain_shift", type=float, default=1.0,
                   help="appearance-shift strength for the synthetic_shifted "
                        "target corpus (adaptation A/B harness)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="host decode threads (batches decoded ahead)")
    p.add_argument("--no_random_flip", action="store_true")
    p.add_argument("--no_random_crop", action="store_true")
    p.add_argument("--device_corpus", choices=["auto", "on", "off"],
                   default="auto",
                   help="decode the corpus once and keep it on the card, "
                        "batches gathered by index (auto: when it fits "
                        "--device_corpus_gb)")
    p.add_argument("--device_corpus_gb", type=float, default=4.0,
                   help="device-memory budget of --device_corpus auto")
    p.add_argument("--decode_cache_gb", type=float, default=4.0,
                   help="RAM cache of decoded samples (0 = off)")
    p.add_argument("--decode_disk_cache_gb", type=float, default=0.0,
                   help="disk cache of decoded samples, beside the corpus "
                        "(0 = off)")
    p.add_argument("--decode_disk_cache_dir", default="",
                   help="root of that cache (default: "
                        "<data_root>/.mcseg_decode_cache)")


def fix_img_shape_args(shape: Sequence[int]) -> tuple:
    """Round (W, H) up to multiples of 8: output-stride-8 trunks need it."""
    w, h = shape
    rnd = lambda v: ((v + 7) // 8) * 8  # noqa: E731
    return (rnd(w), rnd(h))


def get_src_only_training_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("source_train",
                                description="Supervised source-only training")
    p.add_argument("src_dataset",
                   help="suncg|gta5|nyu|city|synthia|ir|synthetic|synthetic_shifted")
    _add_model_args(p)
    _add_train_args(p)
    _add_data_args(p)
    return p


def get_da_mcd_training_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adapt_train", description="MCD UDA training")
    p.add_argument("src_dataset", help="labeled source corpus")
    p.add_argument("tgt_dataset",
                   help="unlabeled target corpus (synthetic_shifted pairs "
                        "with synthetic for the adaptation A/B)")
    p.add_argument("--num_k", type=int, default=4,
                   help="generator (step C) updates per iteration")
    p.add_argument("--d_loss", default="diff", choices=["diff", "symkl"])
    _add_model_args(p)
    _add_train_args(p)
    _add_data_args(p)
    return p


def get_testing_parser(name: str = "test") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(name, description="Evaluate a checkpoint")
    p.add_argument("checkpoint", help="checkpoint prefix (without .pt)")
    p.add_argument("tgt_dataset", nargs="?", default=None,
                   help="default: target dataset from the checkpoint config")
    p.add_argument("--split", default="val")
    p.add_argument("--data_root", default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_img_shape", type=int, nargs=2, default=None)
    p.add_argument("--outdir", default=None,
                   help="label + colour PNG dumps of every prediction")
    p.add_argument("--submit_dir", default=None,
                   help="Cityscapes submission dumps: labelId PNGs named "
                        "after their frames")
    p.add_argument("--saves_prob", action="store_true",
                   help="with --outdir, also float16 probability maps (.npy)")
    p.add_argument("--use_f2", action="store_true",
                   help="average F1 and F2 outputs (adapt_test default; "
                        "opts source_test in)")
    p.add_argument("--f1_only", action="store_true",
                   help="score with F1 alone (disables adapt_test's "
                        "classifier averaging)")
    p.add_argument("--all_devices", action="store_true",
                   help="split each batch over every card of this process")
    p.add_argument("--max_samples", type=int, default=None)
    return p


def reject_unported(args: argparse.Namespace) -> None:
    """Refuse a ``--spatial_devices`` layout the port cannot run
    (``parallel.spatial.check_spatial``: ``ValueError`` for a train height
    the row blocks do not divide at every level of the trunk); a parser
    without the flag passes."""
    space = getattr(args, "spatial_devices", 1)
    if space > 1:
        check_spatial(args.net, fix_img_shape_args(args.train_img_shape)[1], space)


def args_to_config(args: argparse.Namespace, adapt: bool) -> ExperimentConfig:
    tgt = getattr(args, "tgt_dataset", None) or args.src_dataset
    n_class = args.n_class or get_label_spec(tgt)[0]
    train_shape = fix_img_shape_args(args.train_img_shape)
    test_shape = fix_img_shape_args(args.test_img_shape or args.train_img_shape)
    model = ModelConfig(
        net=args.net,
        input_ch=args.input_ch,
        n_class=n_class,
        method="MCD" if adapt else "source",
        fusion=args.fusion,
        uses_one_classifier=args.uses_one_classifier,
        dtype=args.dtype,
        upsample=args.upsample,
        s2d=getattr(args, "s2d", "auto"),
    )
    data = DataConfig(
        src_dataset=args.src_dataset,
        tgt_dataset=tgt,
        split=args.split,
        data_root=args.data_root,
        batch_size=args.batch_size,
        train_img_shape=train_shape,
        test_img_shape=test_shape,
        input_ch=args.input_ch,
        n_class=n_class,
        num_workers=getattr(args, "num_workers", 4),
        random_flip=not args.no_random_flip,
        random_crop=not args.no_random_crop,
        max_samples=args.max_samples,
        domain_shift=getattr(args, "domain_shift", 1.0),
        device_corpus=getattr(args, "device_corpus", "auto"),
        device_corpus_gb=getattr(args, "device_corpus_gb", 4.0),
        decode_cache_gb=getattr(args, "decode_cache_gb", 4.0),
        decode_disk_cache_gb=getattr(args, "decode_disk_cache_gb", 0.0),
        decode_disk_cache_dir=getattr(args, "decode_disk_cache_dir", ""),
    )
    train = TrainConfig(
        opt=args.opt,
        lr=args.lr,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        num_k=getattr(args, "num_k", 4),
        d_loss=getattr(args, "d_loss", "diff"),
        lr_schedule=args.lr_schedule,
        max_steps=args.max_steps,
        seed=args.seed,
        resume=args.resume,
        tb_dir=getattr(args, "tb_dir", ""),
        out_dir=args.out_dir,
        log_every=args.log_every,
        checkpoint_every_epochs=getattr(args, "checkpoint_every_epochs", 1),
        max_hours=getattr(args, "max_hours", 0.0),
        keep_checkpoints=getattr(args, "keep_checkpoints", 0),
        spatial_devices=getattr(args, "spatial_devices", 1),
        async_checkpoint=not getattr(args, "sync_checkpoint", False),
    )
    return ExperimentConfig(model=model, data=data, train=train)
