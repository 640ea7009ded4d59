"""Evaluation: the shared inference core, the eval step and ``evaluate``.

Per batch, all on the device: eval preprocess (with the normalize kernel)
-> G -> one head, F1 alone or a head whose parameters are the average of
F1 and F2 -> bilinear resize of the logits to the label resolution ->
argmax -> confusion-matrix accumulation. Only the final [n, n] matrix reaches the
host. The tester and the serving path (eval/serving.py) both wrap
``make_infer_fn``, so inference cannot drift between them. A multitask
checkpoint's auxiliary heads are scored too: the depth head "D" against
the batch's depth in metres (``eval.depth_metrics``), the boundary head "B"
against the edges of the labels, strict and within a tolerance
(``boundary_match_sums``). With ``submit_dir``, each prediction is also
written in the corpus's submission format (Cityscapes: labelId PNGs named
after the source frames); with ``save_dir``, as label and colour PNGs (and
softmax maps with ``saves_prob``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.core.device import (
    compute_context, compute_dtype, resolve_device, to_device)
from mcseg_tpu_torch.data.datasets import get_dataset
from mcseg_tpu_torch.data.labels import IGNORE, get_label_spec, get_submit_table
from mcseg_tpu_torch.data.pipeline import map_ahead
from mcseg_tpu_torch.data.transforms import save_color_png, save_label_png
from mcseg_tpu_torch.eval.depth_metrics import depth_metric_sums, finalize_depth_metrics
from mcseg_tpu_torch.eval.metrics import fast_hist, format_iou_table, miou_from_hist
from mcseg_tpu_torch.losses.seg import boundary_targets_from_labels
from mcseg_tpu_torch.models.factory import Params, get_aux_heads, get_models
from mcseg_tpu_torch.ops.preprocess import depth_to_meters, make_eval_preprocess
from mcseg_tpu_torch.ops.upsample import resize_bilinear_nchw
from mcseg_tpu_torch.parallel.mesh import (
    DataParallel, all_sum, batch_rows, local_batch_rows)
from mcseg_tpu_torch.utils.profiler import span


def _averaged_head_params(params1: Dict[str, torch.Tensor],
                          params2: Dict[str, torch.Tensor],
                          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Parameters of the one head equal to 0.5 * (F1(feat) + F2(feat)).

    Every op of a PixelClassifier (1x1 conv, bias, fixed bilinear upsample)
    is linear, so averaging the logits equals one application with averaged
    weight and bias: half the score convs and full-resolution upsamples.
    A late-fusion head (the sum of two PixelClassifiers) and the FCN8s
    decoder (three score convs, fixed 2x and 8x upsamples, crops and adds)
    are affine in their parameters too, so the same average holds them;
    the JAX tester scores both in the two-apply form, the same function
    (``tests/test_torch_fusion.py`` and ``tests/test_torch_vgg_psp.py``
    hold the two in float64). The average
    is taken in float32 parameter space (before any bf16 compute cast), in
    float64 under a float64 oracle."""
    if params1.keys() != params2.keys():
        raise ValueError("F1 and F2 differ in structure; cannot average them")
    dt = torch.promote_types(torch.float32, dtype)
    return {k: 0.5 * (params1[k].to(dt) + params2[k].to(dt)) for k in params1}


def batch_to_device(raw_batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Raw planes (numpy arrays or tensors) -> tensors on ``device``; a
    profiled run marks it as the span ``serve.to_device``."""
    with span("serve.to_device"):
        return {k: to_device(torch.as_tensor(v), device) for k, v in raw_batch.items()}


class InferenceCore(nn.Module):
    """``core(batch) -> (logits [B,H,W,n_class], label, feat)`` on planes
    already on the device: eval preprocess (with the normalize kernel) ->
    G -> the head -> resize to ``out_shape``.

    Holds G and one head in eval mode, channels_last: F1 and F2 averaged,
    or F1 alone when ``average_classifiers`` is False (source-only
    scoring), with float32 parameters and BN statistics (float64 under a
    float64 oracle) and bf16 activations through autocast when
    ``cfg.model.dtype`` is bfloat16. Logits are at least float32, at
    ``out_shape`` ((H, W); default: the batch's label resolution). Labels
    are remapped, int32, or None when the batch has none. ``forward`` does
    no host copy and sets no grad mode, so ``torch.export`` traces it; the
    tester and serving both run it."""

    def __init__(self, cfg: ExperimentConfig, params: Params, device,
                 out_shape: Optional[Tuple[int, int]] = None,
                 average_classifiers: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = compute_dtype(cfg.model.dtype)
        param_dtype = torch.float64 if self.dtype == torch.float64 else torch.float32
        g, f1, _ = get_models(cfg.model)
        g.load_state_dict(params["G"])
        f1.to(param_dtype)
        f1.load_state_dict(_averaged_head_params(params["F1"], params["F2"], self.dtype)
                           if average_classifiers else params["F1"])
        self.g, self.head = (m.to(dev, param_dtype).to(memory_format=torch.channels_last).eval()
                             for m in (g, f1))
        self.device = dev
        self.out_shape = out_shape
        img_dtype = torch.bfloat16 if self.dtype == torch.bfloat16 else torch.float32
        self.pp = make_eval_preprocess(cfg.data, out_dtype=img_dtype)

    def forward(self, batch: Dict[str, torch.Tensor]):
        img, label = self.pp(batch)
        # NHWC-contiguous stack == NCHW in channels_last memory: no copy
        x = img.permute(0, 3, 1, 2)
        if self.dtype == torch.float64:
            x = x.to(torch.float64)
        with compute_context(self.dtype, self.device):
            feat = self.g(x)
            logits = self.head(feat)
        oh, ow = self.out_shape if self.out_shape is not None else label.shape[1:3]
        if (oh, ow) != tuple(logits.shape[2:]):
            logits = resize_bilinear_nchw(logits, oh, ow)
        return logits.permute(0, 2, 3, 1), label, feat


def make_infer_fn(cfg: ExperimentConfig, params: Params, device="cuda",
                  out_shape: Optional[Tuple[int, int]] = None,
                  average_classifiers: bool = True):
    """``infer(raw_batch) -> (logits [B,H,W,n_class], label, feat)``: the
    ``InferenceCore`` on ``device`` under ``torch.inference_mode``, fed raw
    planes (numpy arrays or tensors) copied to the device."""
    core = InferenceCore(cfg, params, device, out_shape, average_classifiers)

    @torch.inference_mode()
    def infer(raw_batch):
        return core(batch_to_device(raw_batch, core.device))

    return infer


def load_aux_head(cfg: ExperimentConfig, params: Params, key: str, device) -> torch.nn.Module:
    """The auxiliary head ``key`` ("D" or "B") of ``params`` on ``device``,
    in eval mode, with the parameter dtype of ``make_infer_fn``'s modules."""
    dt = torch.float64 if compute_dtype(cfg.model.dtype) == torch.float64 else torch.float32
    head = get_aux_heads(cfg.model, (key,))[key]
    head.load_state_dict(params[key])
    return head.to(device, dt).to(memory_format=torch.channels_last).eval()


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """[B,C,h,w] -> [B,C,H,W] by bilinear resize, unless already there."""
    return x if tuple(x.shape[2:]) == tuple(hw) else resize_bilinear_nchw(x, *hw)


def boundary_match_sums(b_logits: torch.Tensor, label: torch.Tensor,
                        tol: int = 2) -> Dict[str, torch.Tensor]:
    """Boundary-head counts against the edges of ``label`` [B,H,W]
    (``b_logits`` [B,1,H,W]): strict per-pixel tp/fp/fn at logit > 0, and
    the matches within ``tol`` px (a predicted pixel with a true edge
    within the radius, a true edge with a prediction within it: the
    BSDS/BF-score convention)."""
    tgt, valid = boundary_targets_from_labels(label)
    hit = (b_logits[:, 0] > 0.0) & valid
    pos = (tgt > 0.5) & valid

    def dilate(mask):  # max over a (2 tol + 1)^2 window, clipped at the edges
        k = 2 * tol + 1
        return F.max_pool2d(mask[:, None].to(torch.float32), k, stride=1, padding=tol)[:, 0] > 0

    return {"tp": (hit & pos).sum(), "fp": (hit & ~pos).sum(), "fn": (~hit & pos).sum(),
            "tp_tol_p": (hit & dilate(pos)).sum(), "n_pred": hit.sum(),
            "tp_tol_r": (pos & dilate(hit)).sum(), "n_gt": pos.sum()}


def make_eval_step(cfg: ExperimentConfig, params: Params, device="cuda",
                   average_classifiers: bool = True, with_depth: bool = False,
                   with_boundary: bool = False, boundary_tol: int = 2,
                   with_probs: bool = False):
    """``step(raw_batch) -> (hist [n, n] int64, pred [B,H,W] int32, aux,
    probs)``, on the device. ``aux`` holds, with ``with_depth``, 'depth':
    the depth head's ``depth_metric_sums`` against the batch's 'depth' in
    metres (the prediction resized to its resolution), and with
    ``with_boundary``, 'boundary': ``boundary_match_sums`` of the boundary
    head (resized to the label resolution) at ``boundary_tol``. ``probs``
    is the softmax of the logits, float32 [B,H,W,n_class], with
    ``with_probs``, else None."""
    dev = resolve_device(device)
    infer = make_infer_fn(cfg, params, dev, average_classifiers=average_classifiers)
    n_class = cfg.model.n_class
    dtype = compute_dtype(cfg.model.dtype)
    d_head = load_aux_head(cfg, params, "D", dev) if with_depth else None
    b_head = load_aux_head(cfg, params, "B", dev) if with_boundary else None

    @torch.inference_mode()
    def step(raw_batch):
        logits, label, feat = infer(raw_batch)
        pred = logits.argmax(-1).to(torch.int32)
        aux = {}
        if d_head is not None:
            with compute_context(dtype, dev):
                d_pred = d_head(feat)
            gt = depth_to_meters(to_device(torch.as_tensor(raw_batch["depth"]), dev))
            aux["depth"] = depth_metric_sums(resize_to(d_pred, gt.shape[1:3]), gt)
        if b_head is not None:
            with compute_context(dtype, dev):
                b_logits = b_head(feat)
            aux["boundary"] = boundary_match_sums(resize_to(b_logits, label.shape[1:3]),
                                                  label, boundary_tol)
        probs = torch.softmax(logits, dim=-1) if with_probs else None
        return fast_hist(label, pred, n_class), pred, aux, probs

    return step


def _aux_table_lines(sums: Dict[str, Dict[str, float]], tol: int) -> str:
    """The depth and boundary lines of the JAX tester's table."""
    out = ""
    if "depth" in sums:
        dm = finalize_depth_metrics(sums["depth"])
        out += (f"\ndepth: rmse={dm['rmse']:.4f} m  abs_rel={dm['abs_rel']:.4f}"
                f"  delta<1.25={dm['delta_1.25']:.4f}")
    if "boundary" in sums:
        b = sums["boundary"]
        prec = b["tp"] / max(b["tp"] + b["fp"], 1.0)
        rec = b["tp"] / max(b["tp"] + b["fn"], 1.0)
        f1_score = 2 * prec * rec / max(prec + rec, 1e-9)
        prec_t = b["tp_tol_p"] / max(b["n_pred"], 1.0)
        rec_t = b["tp_tol_r"] / max(b["n_gt"], 1.0)
        f1_t = 2 * prec_t * rec_t / max(prec_t + rec_t, 1e-9)
        out += (f"\nboundary (tol={tol}px): precision={prec_t:.4f}"
                f"  recall={rec_t:.4f}  f1={f1_t:.4f}"
                f"\nboundary (strict):  precision={prec:.4f}  recall={rec:.4f}"
                f"  f1={f1_score:.4f}")
    return out


def padded_batches(dataset, bs: int, num_workers: int = 0, pad_depth: bool = False,
                   rows: Optional[np.ndarray] = None
                   ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Full-size batches over all samples, in order, through the reader's
    ``get_batch``: the tail batch is padded with copies of its last sample
    whose labels are set to ignore (and, with ``pad_depth``, whose depth
    is set to 0, which the depth metrics mask), so padding adds nothing to
    the scores (dropping the tail would skew mIoU). ``num_workers`` > 1
    decodes the next batches on a thread pool; ``rows`` (a rank's
    ``local_batch_rows``) decodes only those rows of each batch. Yields
    (batch, number of real samples in the whole batch)."""
    n = len(dataset)
    keep = list(range(bs)) if rows is None else [int(r) for r in rows]

    def load(start):
        idx = list(range(start, min(start + bs, n)))
        full = idx + [idx[-1]] * (bs - len(idx))
        batch = dataset.get_batch([full[r] for r in keep])
        pad = [i for i, r in enumerate(keep) if r >= len(idx)]
        if pad:
            batch["label"] = batch["label"].copy()
            batch["label"][pad] = IGNORE
            if pad_depth and "depth" in batch:
                batch["depth"] = batch["depth"].copy()
                batch["depth"][pad] = 0
        return batch, len(idx)

    yield from map_ahead(load, range(0, n, bs), num_workers)


def _submit_names(dataset, n: int):
    """The dump names of a submission: the source frames' file names."""
    files = getattr(dataset, "samples", None)
    return [os.path.basename(files[i]["rgb"]) if files else f"{i:06d}.png"
            for i in range(n)]


def evaluate(params: Params, cfg: ExperimentConfig, dataset=None,
             max_batches: Optional[int] = None, print_table: bool = True,
             device="cuda", average_classifiers: bool = True,
             num_workers: Optional[int] = None, submit_dir: Optional[str] = None,
             save_dir: Optional[str] = None, saves_prob: bool = False,
             dp: Optional[DataParallel] = None, devices: Optional[Sequence] = None):
    """Score ``params`` on ``dataset`` (default: the config's target corpus,
    val split) with F1 and F2 averaged, or F1 alone when
    ``average_classifiers`` is False. A multitask checkpoint's depth head
    is scored when the corpus has depth, and its boundary head always;
    their lines follow the IoU table. Batches decode on ``num_workers``
    threads (default ``cfg.data.num_workers``). ``submit_dir`` also dumps
    every prediction in the corpus's submission format, named after its
    source frame (Cityscapes' labelIds; a corpus without a protocol
    raises); on an unlabeled split the table is meaningless and the dumps
    exact. ``save_dir`` writes each real sample's prediction as
    ``{idx:06d}_label.png`` (train ids) and ``{idx:06d}_color.png`` (the
    corpus palette), and with ``saves_prob`` its softmax as
    ``{idx:06d}_prob.npy``, float16 [H,W,n_class]; padding rows are never
    dumped.

    ``dp``: score as one rank of a data-parallel group on ``dp.device``
    (every rank gets the group's result; only rank 0 prints; a group of
    more than one rank cannot dump, as the JAX package's multi-process
    mesh cannot). ``devices``: score on one replica per device of this
    process, each batch's rows split across them. Returns (miou, hist
    int64 [n, n] numpy, table string)."""
    if dp is not None and devices:
        raise ValueError("evaluate takes a data-parallel group or devices, not both")
    if dp is not None and dp.world > 1 and (save_dir or submit_dir):
        raise ValueError("--outdir and --submit_dir cannot be written by a data-parallel "
                         "group of more than one rank; score with one process "
                         "(--all_devices) to dump predictions")
    submit_table = None
    if submit_dir:
        submit_table = get_submit_table(cfg.data.tgt_dataset)
        if submit_table is None:
            raise ValueError(
                f"no submission protocol for corpus {cfg.data.tgt_dataset!r} "
                "(only Cityscapes has an evaluation server)")
        os.makedirs(submit_dir, exist_ok=True)
    devs = ([resolve_device(d) for d in devices] if devices
            else [dp.device if dp is not None else resolve_device(device)])
    dataset = dataset or get_dataset(cfg.data.tgt_dataset, cfg.data, "val")
    _, _, names, palette = get_label_spec(cfg.data.tgt_dataset)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    with_depth = "D" in params and "depth" in dataset[0]
    tol = 2
    n_class = cfg.model.n_class
    bs = min(cfg.data.batch_size, len(dataset))
    parts = dp.world if dp is not None else len(devs)
    bs = max(bs // parts, 1) * parts  # every part holds rows of every batch
    steps = [(make_eval_step(cfg, params, d, average_classifiers, with_depth=with_depth,
                             with_boundary="B" in params, boundary_tol=tol,
                             with_probs=bool(save_dir) and saves_prob),
              None if len(devs) == 1 else local_batch_rows(len(devs), i, bs))
             for i, d in enumerate(devs)]
    if num_workers is None:
        num_workers = cfg.data.num_workers
    total = torch.zeros((n_class, n_class), dtype=torch.int64, device=devs[0])
    aux_total = {}
    dump_names = _submit_names(dataset, len(dataset)) if submit_table is not None else None
    batches = padded_batches(dataset, bs, num_workers, pad_depth=with_depth,
                             rows=batch_rows(dp, bs))
    try:
        for bi, (raw, n_real) in enumerate(batches):
            if max_batches is not None and bi >= max_batches:
                break
            outs = [step(raw if rows is None else
                         {k: v[rows[0]:rows[-1] + 1] for k, v in raw.items()})
                    for step, rows in steps]
            for hist, _, aux, _ in outs:
                total += hist.to(total.device)
                for name, sums in aux.items():
                    acc = aux_total.setdefault(name, {})
                    for k, v in sums.items():
                        acc[k] = acc.get(k, 0) + v.double().to(total.device)
            if save_dir or submit_table is not None:
                pred_np = np.concatenate([pred.cpu().numpy() for _, pred, _, _ in outs])
                probs_np = (torch.cat([probs.to(torch.float16).cpu() for _, _, _, probs in outs])
                            [:n_real].numpy() if outs[0][3] is not None else None)
                for k in range(n_real):
                    idx = bi * bs + k
                    if save_dir:
                        save_label_png(pred_np[k], os.path.join(save_dir, f"{idx:06d}_label.png"))
                        save_color_png(pred_np[k], palette,
                                       os.path.join(save_dir, f"{idx:06d}_color.png"))
                        if probs_np is not None:
                            np.save(os.path.join(save_dir, f"{idx:06d}_prob.npy"), probs_np[k])
                    if submit_table is not None:
                        save_label_png(submit_table[pred_np[k]],
                                       os.path.join(submit_dir, dump_names[idx]))
    finally:
        batches.close()
    if dp is not None:
        total = all_sum(total, dp)
        aux_total = {name: {k: all_sum(v, dp) for k, v in sums.items()}
                     for name, sums in aux_total.items()}
    total = total.cpu().numpy()
    table = format_iou_table(total, names[:n_class]) + _aux_table_lines(
        {name: {k: float(v) for k, v in sums.items()} for name, sums in aux_total.items()},
        tol)
    if print_table and (dp is None or dp.rank == 0):
        print(table)
    return miou_from_hist(total), total, table
