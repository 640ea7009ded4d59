"""The body the training entry points share: refuse unported flags,
config, run directory with ``args.json``, run log, epoch-eval hook,
training loop."""

from __future__ import annotations

import os

from mcseg_tpu_torch.cli._epoch_eval import make_epoch_eval_hook
from mcseg_tpu_torch.cli.argparse_compat import args_to_config, reject_unported
from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.utils.logging import make_run_logger
from mcseg_tpu_torch.utils.util import mkdir_if_not_exist, save_dic_to_json


def run_training(args, train_fn, adapt: bool, device):
    """Train with ``train_fn(cfg, logger=..., on_epoch_end=..., device=...)``
    from the parsed command line ``args``; returns its result."""
    reject_unported(args)
    dev = resolve_device(device)
    cfg = args_to_config(args, adapt=adapt)
    mkdir_if_not_exist(cfg.train.out_dir)
    save_dic_to_json(cfg.to_dict(), os.path.join(cfg.train.out_dir, "args.json"))
    logger = make_run_logger(cfg.train)
    try:
        hook = make_epoch_eval_hook(cfg, args.eval_every_epochs, logger=logger,
                                    device=dev)
        return train_fn(cfg, logger=logger, on_epoch_end=hook, device=dev)
    finally:
        logger.close()
