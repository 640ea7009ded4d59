"""In-process serving: raw planes -> class-id map (and, for a multitask
checkpoint, a depth map), through the same inference core as the tester
(``eval.tester.make_infer_fn``).

Exporting an artifact (``torch.export``) and the probability output come in
a later slice.
"""

from __future__ import annotations

import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.core.device import compute_context, compute_dtype, resolve_device
from mcseg_tpu_torch.eval.tester import load_aux_head, make_infer_fn, resize_to
from mcseg_tpu_torch.models.factory import Params


def make_serve_fn(cfg: ExperimentConfig, params: Params, device="cuda",
                  with_depth: bool = False):
    """Build ``serve(batch) -> pred`` with the parameters loaded on ``device``.

    ``batch``: {'image': uint8 [B,h,w,3]} plus 'depth' (float32 metres or
    uint16 millimetres, [B,h,w]) when input_ch 6 needs HHA — numpy arrays or
    tensors. An input_ch 1 checkpoint also takes a batch without 'image'
    (its 'depth', 'hha' or 'ir' plane alone), as the JAX package's serving
    does; any other input_ch refuses one. ``pred``: int32 train ids
    [B,H,W] on ``device``, (H, W) the config's test_img_shape.
    ``with_depth`` (a multitask checkpoint, with a "D" head) returns
    ``(pred, depth)``, depth the head's metres as float32 [B,H,W]."""
    dev = resolve_device(device)
    tw, th = cfg.data.test_img_shape
    if with_depth and "D" not in params:
        raise ValueError("with_depth needs a multitask checkpoint "
                         "(no 'D' depth-head subtree in params)")
    infer = make_infer_fn(cfg, params, dev, out_shape=(th, tw))
    d_head = load_aux_head(cfg, params, "D", dev) if with_depth else None
    dtype = compute_dtype(cfg.model.dtype)

    @torch.inference_mode()
    def serve(batch):
        if "image" not in batch:
            # only a depth-only checkpoint (input_ch 1) may omit RGB: neither
            # the kernel nor its plain version reads RGB when C is 1
            if cfg.model.input_ch != 1:
                raise ValueError(
                    "serving batch needs an 'image' plane (the checkpoint's "
                    f"input_ch={cfg.model.input_ch} consumes RGB)")
            plane = batch.get("depth", batch.get("hha", batch.get("ir")))
            if plane is None:
                raise ValueError(
                    "depth-only serving batch needs a 'depth' (or 'hha'/"
                    "'ir') plane")
            batch = {**batch, "image": torch.zeros(tuple(plane.shape[:3]) + (3,),
                                                   dtype=torch.uint8, device=dev)}
        logits, _, feat = infer({k: v for k, v in batch.items() if k != "label"})
        pred = logits.argmax(-1).to(torch.int32)
        if d_head is None:
            return pred
        with compute_context(dtype, dev):
            depth = d_head(feat)
        return pred, resize_to(depth, (th, tw))[:, 0].to(torch.float32)

    return serve
