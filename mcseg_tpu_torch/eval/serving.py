"""In-process serving: raw planes -> class-id map, through the same
inference core as the tester (``eval.tester.make_infer_fn``).

Exporting an artifact (``torch.export``), the depth head and the
probability output come in a later slice.
"""

from __future__ import annotations

import torch

from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.eval.tester import make_infer_fn
from mcseg_tpu_torch.models.factory import Params


def make_serve_fn(cfg: ExperimentConfig, params: Params, device="cuda"):
    """Build ``serve(batch) -> pred`` with the parameters loaded on ``device``.

    ``batch``: {'image': uint8 [B,h,w,3]} plus 'depth' (float32 metres or
    uint16 millimetres, [B,h,w]) when input_ch 6 needs HHA — numpy arrays or
    tensors. ``pred``: int32 train ids [B,H,W] on ``device``, (H, W) the
    config's test_img_shape."""
    tw, th = cfg.data.test_img_shape
    infer = make_infer_fn(cfg, params, device, out_shape=(th, tw))

    def serve(batch) -> torch.Tensor:
        if "image" not in batch:
            raise ValueError("serving batch needs an 'image' plane")
        logits, _, _ = infer({k: v for k, v in batch.items() if k != "label"})
        return logits.argmax(-1).to(torch.int32)

    return serve
