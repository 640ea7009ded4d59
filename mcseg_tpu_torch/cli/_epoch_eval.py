"""The ``--eval_every_epochs`` hook of the training entry points.

The port of the JAX package's ``cli/_epoch_eval.py``: at every
``every``-th epoch end it scores the target corpus's val split with
``eval.tester.evaluate`` and logs ``{"step", "epoch", "val_miou"}`` (mIoU in
percent, 3 decimals) into the run's JSONL log. In a data-parallel run
every rank scores its rows under the training group and rank 0 logs.
"""

from __future__ import annotations

from typing import Callable, Optional

from mcseg_tpu_torch.data.datasets import get_dataset
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.parallel.mesh import DataParallel
from mcseg_tpu_torch.parallel.multihost import is_primary


def make_epoch_eval_hook(cfg, every: int, logger=None, device="cuda",
                         dp: Optional[DataParallel] = None) -> Optional[Callable]:
    """``hook(epoch, state)``, or None when ``every`` <= 0 or the target
    corpus has no val split; under ``dp`` every rank must call it."""
    if not every or every <= 0:
        return None
    try:
        dataset = get_dataset(cfg.data.tgt_dataset, cfg.data, "val")
    except FileNotFoundError:
        print("eval_every_epochs: no 'val' split found for "
              f"{cfg.data.tgt_dataset!r}; epoch-end eval disabled")
        return None

    def hook(epoch: int, state):
        if epoch % every:
            return
        miou, _, _ = evaluate(state.params(), cfg, dataset, print_table=False,
                              device=device, dp=dp)
        line = {"step": state.step, "epoch": epoch,
                "val_miou": round(100.0 * float(miou), 3)}
        if logger is not None:
            logger.log(line)
        elif is_primary():
            print(f"epoch={epoch}  val_mIoU={line['val_miou']}", flush=True)

    return hook
