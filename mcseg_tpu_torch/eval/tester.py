"""Evaluation: the shared inference core, the eval step and ``evaluate``.

Per batch, all on the device: eval preprocess (with the normalize kernel)
-> G -> one head, F1 alone or a head whose parameters are the average of
F1 and F2 -> bilinear resize of the logits to the label resolution ->
argmax -> confusion-matrix accumulation. Only the final [n, n] matrix reaches the
host. The tester and the serving path (eval/serving.py) both wrap
``make_infer_fn``, so inference cannot drift between them.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.core.device import compute_context, compute_dtype, resolve_device
from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
from mcseg_tpu_torch.data.labels import IGNORE, get_label_spec
from mcseg_tpu_torch.eval.metrics import fast_hist, format_iou_table, miou_from_hist
from mcseg_tpu_torch.models.factory import Params, get_models
from mcseg_tpu_torch.ops.preprocess import make_eval_preprocess
from mcseg_tpu_torch.ops.upsample import resize_bilinear_nchw


def _averaged_head_params(params1: Dict[str, torch.Tensor],
                          params2: Dict[str, torch.Tensor],
                          dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Parameters of the one head equal to 0.5 * (F1(feat) + F2(feat)).

    Every op of a PixelClassifier (1x1 conv, bias, fixed bilinear upsample)
    is linear, so averaging the logits equals one application with averaged
    weight and bias: half the score convs and full-resolution upsamples.
    A late-fusion head is the sum of two PixelClassifiers, linear in its
    parameters too, so the same average holds it; the JAX tester scores
    late fusion in the two-apply form, the same function
    (``tests/test_torch_fusion.py`` holds the two in float64). The average
    is taken in float32 parameter space (before any bf16 compute cast), in
    float64 under a float64 oracle."""
    if params1.keys() != params2.keys():
        raise ValueError("F1 and F2 differ in structure; cannot average them")
    dt = torch.promote_types(torch.float32, dtype)
    return {k: 0.5 * (params1[k].to(dt) + params2[k].to(dt)) for k in params1}


def batch_to_device(raw_batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Raw planes (numpy arrays or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in raw_batch.items()}


def make_infer_fn(cfg: ExperimentConfig, params: Params, device="cuda",
                  out_shape: Optional[Tuple[int, int]] = None,
                  average_classifiers: bool = True):
    """``infer(raw_batch) -> (logits [B,H,W,n_class], label, feat)``.

    Loads ``params`` onto ``device`` (float32 parameters and BN statistics;
    bf16 activations through autocast when ``cfg.model.dtype`` is
    bfloat16). The head is F1 and F2 averaged, or F1 alone when
    ``average_classifiers`` is False (source-only scoring). Logits are at
    least float32, resized to ``out_shape`` ((H, W); default: the batch's
    label resolution). Labels are remapped, int32, or None when the batch
    has none."""
    dev = resolve_device(device)
    dtype = compute_dtype(cfg.model.dtype)
    param_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    g, f1, _ = get_models(cfg.model)
    g.load_state_dict(params["G"])
    f1.to(param_dtype)
    f1.load_state_dict(_averaged_head_params(params["F1"], params["F2"], dtype)
                       if average_classifiers else params["F1"])
    g, head = (m.to(dev, param_dtype).to(memory_format=torch.channels_last).eval()
               for m in (g, f1))
    img_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    pp = make_eval_preprocess(cfg.data, out_dtype=img_dtype)

    @torch.inference_mode()
    def infer(raw_batch):
        img, label = pp(batch_to_device(raw_batch, dev))
        # NHWC-contiguous stack == NCHW in channels_last memory: no copy
        x = img.permute(0, 3, 1, 2)
        if dtype == torch.float64:
            x = x.to(torch.float64)
        with compute_context(dtype, dev):
            feat = g(x)
            logits = head(feat)
        oh, ow = out_shape if out_shape is not None else label.shape[1:3]
        if (oh, ow) != tuple(logits.shape[2:]):
            logits = resize_bilinear_nchw(logits, oh, ow)
        return logits.permute(0, 2, 3, 1), label, feat

    return infer


def make_eval_step(cfg: ExperimentConfig, params: Params, device="cuda",
                   average_classifiers: bool = True):
    """``step(raw_batch) -> (hist [n, n] int64, pred [B,H,W] int32)``, both
    on the device."""
    infer = make_infer_fn(cfg, params, device, average_classifiers=average_classifiers)
    n_class = cfg.model.n_class

    def step(raw_batch):
        logits, label, _ = infer(raw_batch)
        pred = logits.argmax(-1).to(torch.int32)
        return fast_hist(label, pred, n_class), pred

    return step


def padded_batches(dataset, bs: int) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
    """Full-size batches over all samples: the tail batch is padded with
    copies of its last sample whose labels are set to ignore, so padding
    adds nothing to the confusion matrix (dropping the tail would skew
    mIoU). Yields (batch, number of real samples)."""
    n = len(dataset)
    for start in range(0, n, bs):
        idx = list(range(start, min(start + bs, n)))
        n_pad = bs - len(idx)
        batch = stack_samples(dataset, idx + [idx[-1]] * n_pad)
        if n_pad:
            batch["label"][len(idx):] = IGNORE
        yield batch, len(idx)


def evaluate(params: Params, cfg: ExperimentConfig, dataset=None,
             max_batches: Optional[int] = None, print_table: bool = True,
             device="cuda", average_classifiers: bool = True):
    """Score ``params`` on ``dataset`` (default: the config's target corpus,
    val split) with F1 and F2 averaged, or F1 alone when
    ``average_classifiers`` is False. Returns (miou, hist int64 [n, n]
    numpy, table string)."""
    dev = resolve_device(device)
    dataset = dataset or get_dataset(cfg.data.tgt_dataset, cfg.data, "val")
    _, _, names, _ = get_label_spec(cfg.data.tgt_dataset)
    step = make_eval_step(cfg, params, dev, average_classifiers)
    n_class = cfg.model.n_class
    bs = min(cfg.data.batch_size, len(dataset))
    total = torch.zeros((n_class, n_class), dtype=torch.int64, device=dev)
    for bi, (raw, _) in enumerate(padded_batches(dataset, bs)):
        if max_batches is not None and bi >= max_batches:
            break
        hist, _ = step(raw)
        total += hist
    total = total.cpu().numpy()
    table = format_iou_table(total, names[:n_class])
    if print_table:
        print(table)
    return miou_from_hist(total), total, table
