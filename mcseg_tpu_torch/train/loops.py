"""The training loops: MCD adaptation, source-only and multitask.

The port of the JAX package's ``train/loops.py`` ``train_adapt``,
``train_source`` and ``train_multitask``. Batches of raw planes (zipped
source and target for adaptation) go to the device, through the train
preprocess (with the normalize kernel) and the step. The crop and flip draws of iteration
``step`` come from a generator seeded by ``(seed + 1, step)``, so a resumed
run repeats an uninterrupted one. The loops share one body
(``_train_loop``): the NaN guard at log points, a graceful stop on
SIGTERM/SIGINT or after ``max_hours``, per-epoch checkpoints pruned to
``keep_checkpoints`` (written in the background unless
``--sync_checkpoint``; ``_EpochSaver``), ``last`` at the end, written
synchronously, and resume from an epoch boundary after a check that the
checkpoint has the requested structure.

Data parallelism (``dp``, a ``parallel.mesh.DataParallel``): every rank
draws the same global index stream and crop and flip draws, and keeps its
rows of each global batch of ``batch_size``; its step reduces losses,
BatchNorm statistics and gradients over the group, so the run is the
single-process run of the global batch. Every rank starts from rank 0's
state, and only rank 0 writes the run directory (logs, ``ep<N>``, pruning,
``last``), followed by a barrier.

Spatial partitioning (``dp.space`` > 1, JAX's ``_spatial``): the rows of
the global batch go to data blocks, and every rank of a block receives,
draws for and preprocesses the block's whole images (HHA's gravity is a
per-image estimate), then keeps its row block of each preprocessed input
(``parallel.spatial.shard_rows``) for the step, whose convs, upsamples,
BatchNorm and losses then work on row blocks.
"""

from __future__ import annotations

import functools
import math
import os
import signal
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.core.device import compute_dtype, resolve_device
from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
from mcseg_tpu_torch.data.device_corpus import corpus_stream, resolve_device_corpus
from mcseg_tpu_torch.data.pipeline import batch_iterator, device_prefetch
from mcseg_tpu_torch.models.factory import get_aux_heads
from mcseg_tpu_torch.ops.preprocess import (
    draw_augment, make_train_preprocess, pre_crop_canvas)
from mcseg_tpu_torch.losses.seg import boundary_targets_from_labels
from mcseg_tpu_torch.parallel.mesh import DataParallel, batch_rows, data_blocks
from mcseg_tpu_torch.parallel.multihost import sync
from mcseg_tpu_torch.parallel.spatial import check_spatial, shard_rows
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.multitask import (
    aux_head_keys, make_multitask_mcd_step, make_multitask_source_step)
from mcseg_tpu_torch.train.source import make_source_step
from mcseg_tpu_torch.train.state import MCDTrainState, create_train_state
from mcseg_tpu_torch.utils.checkpoint import (
    AsyncCheckpointer, load_checkpoint, load_config, prune_epoch_checkpoints,
    save_checkpoint)
from mcseg_tpu_torch.utils.logging import JsonlLogger, StepTimer, make_run_logger
from mcseg_tpu_torch.utils.profiler import span


def augment_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of iteration ``step``'s crop and flip draws."""
    mixed = np.random.SeedSequence([seed + 1, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed) & (2**63 - 1))


def _as_input(dtype: torch.dtype) -> Callable:
    def as_input(img):
        # the NHWC-contiguous stack is NCHW in channels_last memory: no copy
        x = img.permute(0, 3, 1, 2)
        return x.to(torch.float64) if dtype == torch.float64 else x

    return as_input


def _img_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _draws(gen: torch.Generator, b: int, pre, target, cfg: ExperimentConfig,
           dp: Optional[DataParallel]):
    """The crop and flip draws of this rank's ``b`` rows: those of the
    global batch of ``b * data blocks`` rows, drawn whole on every rank,
    then cut to the rows of the rank's data block. A profiled run marks
    the draws as the span ``train.draws``, as it marks their copy to the
    card in the preprocess."""
    with span("train.draws"):
        draws = draw_augment(gen, b * data_blocks(dp), pre, target, cfg.data)
        rows = batch_rows(dp, b * data_blocks(dp))
        if rows is None:
            return draws
        return tuple(t[int(rows[0]):int(rows[-1]) + 1] for t in draws)


def make_adapt_iteration(cfg: ExperimentConfig, dp: Optional[DataParallel] = None
                         ) -> Callable:
    """``iterate(state, src, tgt, mark=None) -> metrics``: one training
    iteration on batches of raw planes already on the state's device —
    train preprocess of both (two launches of the normalize kernel), then
    the MCD step. The target batch's labels are not read. ``mark`` is
    passed to the step, and also called with 'preprocess' after both
    preprocesses. Under ``dp`` the batches are the rows of this rank's data
    block of the global batch, and under spatial partitioning the step gets
    the rank's row block of each preprocessed input. A profiled run marks
    each call as the root span ``train.iteration`` and both preprocesses as
    ``train.preprocess`` (so do the other trainers' ``iterate``)."""
    dtype = compute_dtype(cfg.model.dtype)
    pp = make_train_preprocess(cfg.data, _img_dtype(dtype))
    step = make_mcd_step(cfg.train, cfg.model.uses_one_classifier, dtype, dp)
    pre, target = pre_crop_canvas(cfg.data)
    as_input = _as_input(dtype)

    def iterate(state: MCDTrainState, src, tgt, mark=None):
        with span("train.iteration"):
            with span("train.preprocess"):
                gen = augment_generator(cfg.train.seed, state.step)
                b = src["image"].shape[0]
                xs, ys = pp(src, *_draws(gen, b, pre, target, cfg, dp))
                xt, _ = pp({k: v for k, v in tgt.items() if k != "label"},
                           *_draws(gen, b, pre, target, cfg, dp))
                xs, ys, xt = shard_rows(dp, xs, ys, xt)
            if mark:
                mark("preprocess")
            return step(state, as_input(xs), ys, as_input(xt), mark)

    return iterate


def make_source_iteration(cfg: ExperimentConfig, dp: Optional[DataParallel] = None
                          ) -> Callable:
    """``iterate(state, src) -> metrics``: one source-only step on a batch
    of raw planes already on the state's device — train preprocess (one
    launch of the normalize kernel), then the source step. ``dp`` as in
    ``make_adapt_iteration``."""
    dtype = compute_dtype(cfg.model.dtype)
    pp = make_train_preprocess(cfg.data, _img_dtype(dtype))
    step = make_source_step(cfg.train, dtype, dp)
    pre, target = pre_crop_canvas(cfg.data)
    as_input = _as_input(dtype)

    def iterate(state: MCDTrainState, src):
        with span("train.iteration"):
            with span("train.preprocess"):
                gen = augment_generator(cfg.train.seed, state.step)
                x, y = shard_rows(dp, *pp(src, *_draws(gen, src["image"].shape[0], pre,
                                                          target, cfg, dp)))
            return step(state, as_input(x), y)

    return iterate


def _row_split_boundary(dp: Optional[DataParallel], labels: torch.Tensor,
                        boundary_weight: float):
    """Under spatial partitioning with a boundary head, this rank's row
    block of the boundary targets and their valid mask, derived from the
    whole labels (a pixel's target reads the rows beside it); else None, and
    the step derives them from its labels."""
    if dp is None or dp.space == 1 or boundary_weight <= 0:
        return None
    return shard_rows(dp, *boundary_targets_from_labels(labels))


def make_multitask_iteration(cfg: ExperimentConfig, depth_weight: float = 0.5,
                             boundary_weight: float = 0.0,
                             dp: Optional[DataParallel] = None) -> Callable:
    """``iterate(state, src, tgt, mark=None) -> metrics``: one multitask MCD
    iteration — train preprocess of the source batch with its depth plane
    and of the target batch (two launches of the normalize kernel), then
    ``make_multitask_mcd_step``. The target batch's labels are not read.
    ``mark`` and ``dp`` as in ``make_adapt_iteration``."""
    dtype = compute_dtype(cfg.model.dtype)
    pp_src = make_train_preprocess(cfg.data, _img_dtype(dtype), with_depth=True)
    pp_tgt = make_train_preprocess(cfg.data, _img_dtype(dtype))
    step = make_multitask_mcd_step(cfg.train, depth_weight, boundary_weight, dtype, dp)
    pre, target = pre_crop_canvas(cfg.data)
    as_input = _as_input(dtype)

    def iterate(state: MCDTrainState, src, tgt, mark=None):
        with span("train.iteration"):
            with span("train.preprocess"):
                gen = augment_generator(cfg.train.seed, state.step)
                b = src["image"].shape[0]
                xs, ys, ds = pp_src(src, *_draws(gen, b, pre, target, cfg, dp))
                xt, _ = pp_tgt({k: v for k, v in tgt.items() if k != "label"},
                               *_draws(gen, b, pre, target, cfg, dp))
                bnd = _row_split_boundary(dp, ys, boundary_weight)
                xs, ys, ds, xt = shard_rows(dp, xs, ys, ds, xt)
            if mark:
                mark("preprocess")
            return step(state, as_input(xs), ys, ds, as_input(xt), mark, boundary=bnd)

    return iterate


def make_multitask_source_iteration(cfg: ExperimentConfig, depth_weight: float = 0.5,
                                    boundary_weight: float = 0.0,
                                    dp: Optional[DataParallel] = None) -> Callable:
    """``iterate(state, src) -> metrics``: one source-only multitask step —
    train preprocess with the depth plane (one launch of the normalize
    kernel), then ``make_multitask_source_step``. ``dp`` as in
    ``make_adapt_iteration``."""
    dtype = compute_dtype(cfg.model.dtype)
    pp = make_train_preprocess(cfg.data, _img_dtype(dtype), with_depth=True)
    step = make_multitask_source_step(cfg.train, depth_weight, boundary_weight, dtype, dp)
    pre, target = pre_crop_canvas(cfg.data)
    as_input = _as_input(dtype)

    def iterate(state: MCDTrainState, src):
        with span("train.iteration"):
            with span("train.preprocess"):
                gen = augment_generator(cfg.train.seed, state.step)
                x, y, d = pp(src, *_draws(gen, src["image"].shape[0], pre, target, cfg, dp))
                bnd = _row_split_boundary(dp, y, boundary_weight)
                x, y, d = shard_rows(dp, x, y, d)
            return step(state, as_input(x), y, d, boundary=bnd)

    return iterate


def check_finite(metrics, step: int) -> None:
    """NaN guard: fail with context instead of training on garbage."""
    for k, v in metrics.items():
        if not math.isfinite(float(v)):
            raise FloatingPointError(
                f"non-finite metric {k}={float(v)} at step {step}; "
                "lower --lr or inspect the input pipeline")


class GracefulStop:
    """The first SIGTERM/SIGINT lets the running iteration finish, then the
    loop writes its final checkpoint and returns; a second raises
    KeyboardInterrupt. ``max_hours`` ends the run the same way."""

    def install(self, max_hours: float = 0.0) -> "GracefulStop":
        self._deadline = time.time() + max_hours * 3600 if max_hours else None
        self.stop = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread
                pass
        return self

    def _handle(self, signum, frame):
        if self.stop:
            raise KeyboardInterrupt(f"second signal {signum}: hard stop")
        self.stop = True
        print(f"signal {signum}: finishing the current iteration, then "
              "writing the final checkpoint and exiting", flush=True)

    def expired(self) -> bool:
        if self._deadline is not None and time.time() > self._deadline:
            if not self.stop:
                print("max_hours budget exhausted: writing the final "
                      "checkpoint and exiting", flush=True)
                self.stop = True
            return True
        return False

    def restore(self) -> None:
        for sig, h in self._prev.items():
            signal.signal(sig, h)


class _EpochSaver:
    """The loops' epoch checkpoints: through an ``AsyncCheckpointer`` (the
    loop steps on while the file is written), or synchronously under
    ``--sync_checkpoint``; pruning to ``keep_checkpoints`` runs after the
    write publishes either way. ``close`` waits for pending writes, before
    the loop writes ``last`` synchronously, so a returned loop leaves a
    complete run directory. Only the ``primary`` rank writes; on the other
    ranks of a data-parallel job the saver does nothing."""

    def __init__(self, cfg: ExperimentConfig, out_dir: str, primary: bool = True):
        self._cfg, self._out_dir, self._primary = cfg, out_dir, primary
        self._async = (AsyncCheckpointer() if cfg.train.async_checkpoint and primary
                       else None)

    def save_epoch(self, epoch: int, state: MCDTrainState) -> None:
        if not self._primary:
            return
        prefix = os.path.join(self._out_dir, f"ep{epoch}")
        prune = functools.partial(prune_epoch_checkpoints, self._out_dir,
                                  self._cfg.train.keep_checkpoints)
        if self._async is not None:
            self._async.save(prefix, state, self._cfg, after=prune)
        else:
            save_checkpoint(prefix, state, self._cfg)
            prune()

    def close(self) -> None:
        """Wait for pending writes; raise a writer failure."""
        if self._async is not None:
            self._async.close()


def _input_stream(dataset, dev: torch.device, cfg: ExperimentConfig, start_epoch: int,
                  dp: Optional[DataParallel] = None):
    """The batches of the run on ``dev``: the card-resident corpus when
    ``--device_corpus`` resolves on (decoded once, gathered by index),
    else host decode on ``num_workers`` threads with prefetch to the
    device. Both yield the same tensors for a seed; under ``dp``, this
    rank's rows of each global batch."""
    bs, seed, epochs = cfg.data.batch_size, cfg.train.seed, cfg.train.epochs
    rows = batch_rows(dp, bs)
    if resolve_device_corpus(cfg.data, dataset):
        return corpus_stream(dataset, dev, bs, seed=seed, epochs=epochs,
                             start_epoch=start_epoch, local_rows=rows)
    return device_prefetch(
        batch_iterator(dataset, bs, seed=seed, epochs=epochs, start_epoch=start_epoch,
                       num_workers=cfg.data.num_workers, local_rows=rows), dev)


# Checkpoint fields that determine the model and optimizer structure:
# resuming with another value would restore the weights into another
# architecture, so the loops compare them before any state is built.
_RESUME_STRUCTURAL_FIELDS = (
    ("model", "net"), ("model", "input_ch"), ("model", "n_class"),
    ("model", "method"), ("model", "fusion"), ("model", "upsample"),
    ("train", "opt"),
)


def _check_resume_config(cli_cfg: ExperimentConfig, ckpt_cfg: ExperimentConfig,
                         resume_path: str) -> None:
    drift = []
    for section, name in _RESUME_STRUCTURAL_FIELDS:
        cli_v = getattr(getattr(cli_cfg, section), name)
        ckpt_v = getattr(getattr(ckpt_cfg, section), name)
        if cli_v != ckpt_v:
            drift.append(f"--{name}: checkpoint has {ckpt_v!r}, CLI has {cli_v!r}")
    if drift:
        raise ValueError(
            f"--resume {resume_path!r} config mismatch — the checkpointed model "
            "cannot be restored into the requested architecture:\n  "
            + "\n  ".join(drift)
            + "\nDrop the conflicting flag(s) or resume a matching checkpoint."
        )


def _check_resume_heads(state: MCDTrainState, aux_heads: Sequence[str],
                        resume_path: str) -> None:
    """The multitask trainer's checks of a resumed state, with the JAX
    package's messages: a depth head, and a boundary head exactly when the
    run trains one."""
    if state.d is None:
        raise ValueError(
            f"--resume {resume_path!r} is not a multitask checkpoint "
            "(no 'D' depth-head subtree)")
    has_b, want_b = state.b is not None, "B" in aux_heads
    if has_b != want_b:
        raise ValueError(
            f"--resume {resume_path!r}: boundary-head mismatch — "
            f"checkpoint {'has' if has_b else 'lacks'} a 'B' "
            f"subtree but --boundary_weight is "
            f"{'set' if want_b else 'unset'}")


def _init_or_resume(cfg: ExperimentConfig, dev: torch.device,
                    aux_heads: Sequence[str] = ()) -> MCDTrainState:
    if cfg.train.resume:
        _check_resume_config(cfg, load_config(cfg.train.resume), cfg.train.resume)
        state, _ = load_checkpoint(cfg.train.resume, dev, config=cfg)
        if aux_heads:
            _check_resume_heads(state, aux_heads, cfg.train.resume)
        return state
    return create_train_state(cfg.model, cfg.train, cfg.train.seed, dev,
                              aux_heads=aux_heads)


def _train_loop(cfg: ExperimentConfig, dataset, iterate: Callable,
                logger: Optional[JsonlLogger], max_iterations: Optional[int],
                on_epoch_end: Optional[Callable], dev: torch.device,
                aux_heads: Sequence[str] = (),
                dp: Optional[DataParallel] = None) -> MCDTrainState:
    """The loop the trainers share: ``iterate(state, *batches)`` on each
    item of the input stream of ``dataset`` on ``dev`` (a pair of batches
    for a ZipDataset); the state carries the auxiliary heads
    ``aux_heads``. Under ``dp`` the state starts as rank 0's, the stream
    holds the rows of this rank's data block, and only rank 0 writes. A
    spatial layout the port cannot run raises before any state is built."""
    batch_rows(dp, cfg.data.batch_size)  # refuses a batch the data blocks do not divide
    check_spatial(cfg.model.net, cfg.data.train_img_shape[1], dp.space if dp else 1)
    state = _init_or_resume(cfg, dev, aux_heads)
    state.broadcast_from_primary(dp)
    state.set_data_parallel(dp)
    primary = dp is None or dp.rank == 0
    out_dir = cfg.train.out_dir
    if primary:
        os.makedirs(out_dir, exist_ok=True)
    own_logger = logger is None
    logger = logger or make_run_logger(cfg.train)
    bs = cfg.data.batch_size
    step0 = state.step
    steps_per_epoch = max(len(dataset) // bs, 1)
    # checkpoints fall on epoch boundaries; a mid-epoch step replays its
    # epoch from the start
    start_epoch = step0 // steps_per_epoch if cfg.train.resume else 0
    stream = _input_stream(dataset, dev, cfg, start_epoch, dp)
    saver = _EpochSaver(cfg, out_dir, primary)
    timer = StepTimer()
    stop = GracefulStop().install(cfg.train.max_hours)
    try:
        for i, item in enumerate(stream):
            if stop.stop or (i > 0 and stop.expired()) or (
                    max_iterations is not None and i >= max_iterations):
                break
            metrics = iterate(state, *(item if isinstance(item, tuple) else (item,)))
            timer.tick(bs)
            if i % cfg.train.log_every == 0:
                check_finite(metrics, step0 + i)
                logger.log({"step": step0 + i, **metrics,
                            "img_per_sec": timer.items_per_sec})
            if (i + 1) % steps_per_epoch == 0:
                epoch = start_epoch + (i + 1) // steps_per_epoch
                if (cfg.train.checkpoint_every_epochs > 0
                        and epoch % cfg.train.checkpoint_every_epochs == 0):
                    saver.save_epoch(epoch, state)
                if on_epoch_end:
                    on_epoch_end(epoch, state)
    finally:
        stream.close()
        stop.restore()
        if own_logger:
            logger.close()
        saver.close()
    if primary:
        save_checkpoint(os.path.join(out_dir, "last"), state, cfg)
    if dp is not None:
        sync()  # no rank leaves while rank 0 writes
    return state


def _device(device, dp: Optional[DataParallel]) -> torch.device:
    """The run's card: the data-parallel context's, else ``device``."""
    return dp.device if dp is not None else resolve_device(device)


def train_adapt(cfg: ExperimentConfig, logger: Optional[JsonlLogger] = None,
                max_iterations: Optional[int] = None,
                on_epoch_end: Optional[Callable] = None,
                device="cuda", dp: Optional[DataParallel] = None) -> MCDTrainState:
    """MCD adaptation training on ``device``: ``cfg.train.epochs`` epochs
    (or ``max_iterations``) over the zipped source and target corpora,
    from ``cfg.train.resume`` when set. Writes ``ep<N>`` checkpoints every
    ``checkpoint_every_epochs`` and ``last`` at the end into
    ``cfg.train.out_dir``; returns the final state. Under ``dp``
    (``parallel.multihost.initialize``) this process is one rank of a
    data-parallel run of global batch ``cfg.data.batch_size`` on
    ``dp.device``, and every rank returns the same state."""
    dev = _device(device, dp)
    zipped = ZipDataset(get_dataset(cfg.data.src_dataset, cfg.data, cfg.data.split),
                        get_dataset(cfg.data.tgt_dataset, cfg.data, cfg.data.split))
    return _train_loop(cfg, zipped, make_adapt_iteration(cfg, dp), logger,
                       max_iterations, on_epoch_end, dev, dp=dp)


def train_source(cfg: ExperimentConfig, logger: Optional[JsonlLogger] = None,
                 max_iterations: Optional[int] = None,
                 on_epoch_end: Optional[Callable] = None,
                 device="cuda", dp: Optional[DataParallel] = None) -> MCDTrainState:
    """Supervised source-only training on ``device`` over the source
    corpus; otherwise as ``train_adapt``."""
    dev = _device(device, dp)
    dataset = get_dataset(cfg.data.src_dataset, cfg.data, cfg.data.split)
    return _train_loop(cfg, dataset, make_source_iteration(cfg, dp), logger,
                       max_iterations, on_epoch_end, dev, dp=dp)


def train_multitask(cfg: ExperimentConfig, depth_weight: float = 0.5,
                    boundary_weight: float = 0.0, adapt: bool = True,
                    logger: Optional[JsonlLogger] = None,
                    max_iterations: Optional[int] = None,
                    on_epoch_end: Optional[Callable] = None,
                    device="cuda", dp: Optional[DataParallel] = None) -> MCDTrainState:
    """Multitask training on ``device``: segmentation plus the depth head
    (berHu, ``depth_weight``) and, when ``boundary_weight`` > 0, the
    boundary head, with MCD over the zipped corpora (``adapt``) or on the
    source corpus alone; otherwise as ``train_adapt``. A resumed
    checkpoint must hold a depth head, and a boundary head exactly when
    ``boundary_weight`` > 0. Late fusion raises before any state is
    built. ``dp`` as in ``train_adapt``."""
    dev = _device(device, dp)
    aux = aux_head_keys(boundary_weight)
    get_aux_heads(cfg.model, aux)  # refuses late fusion up front
    src = get_dataset(cfg.data.src_dataset, cfg.data, cfg.data.split)
    if adapt:
        dataset = ZipDataset(src, get_dataset(cfg.data.tgt_dataset, cfg.data, cfg.data.split))
        iterate = make_multitask_iteration(cfg, depth_weight, boundary_weight, dp)
    else:
        dataset = src
        iterate = make_multitask_source_iteration(cfg, depth_weight, boundary_weight, dp)
    return _train_loop(cfg, dataset, iterate, logger, max_iterations, on_epoch_end, dev,
                       aux_heads=aux, dp=dp)
