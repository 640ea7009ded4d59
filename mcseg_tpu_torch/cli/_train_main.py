"""The body the training entry points share: refuse a layout the port
cannot run, join the data-parallel job when ``--multihost`` or
``--coordinator`` asks for one (laid out in row blocks by
``--spatial_devices``), config, run directory with ``args.json`` (rank 0),
run log, epoch-eval hook, training loop."""

from __future__ import annotations

import os

from mcseg_tpu_torch.cli._epoch_eval import make_epoch_eval_hook
from mcseg_tpu_torch.cli.argparse_compat import args_to_config, reject_unported
from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.parallel.mesh import batch_rows
from mcseg_tpu_torch.parallel.multihost import is_primary, maybe_initialize_from_args
from mcseg_tpu_torch.parallel.spatial import across_data
from mcseg_tpu_torch.utils.logging import make_run_logger
from mcseg_tpu_torch.utils.util import mkdir_if_not_exist, save_dic_to_json


def run_training(args, train_fn, adapt: bool, device):
    """Train with ``train_fn(cfg, logger=..., on_epoch_end=..., device=...,
    dp=...)`` from the parsed command line ``args``; returns its result.
    Without the parallelism flags the run has one process on ``device``;
    with them, this process is one rank, on its own card, and leaves the
    job at the end. Every refusal (a layout the port cannot run, a
    ``--spatial_devices`` that does not divide the ranks, a batch the data
    blocks do not divide) comes before anything is written."""
    reject_unported(args)
    with maybe_initialize_from_args(args, device) as dp:
        dev = dp.device if dp is not None else resolve_device(device)
        cfg = args_to_config(args, adapt=adapt)
        batch_rows(dp, cfg.data.batch_size)  # refuses a batch the data blocks do not divide
        if is_primary():
            mkdir_if_not_exist(cfg.train.out_dir)
            save_dic_to_json(cfg.to_dict(), os.path.join(cfg.train.out_dir, "args.json"))
        logger = make_run_logger(cfg.train)
        try:
            hook = make_epoch_eval_hook(cfg, args.eval_every_epochs, logger=logger,
                                        device=dev, dp=across_data(dp))
            return train_fn(cfg, logger=logger, on_epoch_end=hook, device=dev, dp=dp)
        finally:
            logger.close()
