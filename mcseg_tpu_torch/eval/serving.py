"""Serving: raw planes -> class-id map (and, for a multitask checkpoint, a
depth map; on request, softmax probabilities), in process or as an
exported artifact.

The port of the JAX package's ``eval/serving.py``. ``ServeModule`` runs the
tester's inference core (``eval.tester.InferenceCore``), so serving and
scoring cannot drift. ``export_serving`` freezes the whole path, raw planes
-> preprocess (HHA and the normalize kernel included) -> trunk -> head ->
argmax, into one ``torch.export`` program: parameters inside, static
shapes, the kernels as the custom ops ``mcseg::normalize_stack`` and
``mcseg::upsample_convt`` (the heads' ``convt`` upsample). The file is
``torch.export.save`` of that program beside a ``.json`` manifest;
``load_serving`` needs only this module (which registers the ops) and
PyTorch.
"""

from __future__ import annotations

import io
import json
import os
import warnings
from typing import Dict, Optional, Tuple

import torch
from torch import nn

# register mcseg::normalize_stack and mcseg::upsample_convt, which an
# artifact's graph calls
import mcseg_tpu_torch.ops.normalize  # noqa: F401
import mcseg_tpu_torch.ops.upsample  # noqa: F401
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.core.device import compute_context, resolve_device
from mcseg_tpu_torch.eval.tester import (
    InferenceCore, batch_to_device, load_aux_head, resize_to)
from mcseg_tpu_torch.models.factory import Params
from mcseg_tpu_torch.utils.profiler import span

_DTYPES = {"uint8": torch.uint8, "float32": torch.float32}


class ServeModule(nn.Module):
    """``serve(batch) -> pred[, depth][, probs]`` on planes already on the
    device.

    ``batch``: {'image': uint8 [B,h,w,3]} plus 'depth' (float32 metres or
    uint16 millimetres, [B,h,w]) when input_ch 6 needs HHA, or the 'hha',
    'ir' or 'boundary' plane its preprocess reads. An input_ch 1 checkpoint
    also takes a batch without 'image' (its 'depth', 'hha' or 'ir' plane
    alone); any other input_ch refuses one. ``pred``: int32 train ids
    [B,H,W], (H, W) = ``out_shape`` (default: the config's test_img_shape).
    ``with_depth`` (a multitask checkpoint, with a "D" head) adds the head's
    metres as float32 [B,H,W]; ``with_probs`` the softmax over classes,
    float32 [B,H,W,n_class], last. The head averages F1 and F2 unless
    ``average_classifiers`` is False."""

    def __init__(self, cfg: ExperimentConfig, params: Params, device="cuda",
                 average_classifiers: bool = True,
                 out_shape: Optional[Tuple[int, int]] = None,
                 with_probs: bool = False, with_depth: bool = False):
        super().__init__()
        dev = resolve_device(device)
        if out_shape is None:
            tw, th = cfg.data.test_img_shape
            out_shape = (th, tw)
        if with_depth and "D" not in params:
            raise ValueError("with_depth needs a multitask checkpoint "
                             "(no 'D' depth-head subtree in params)")
        self.core = InferenceCore(cfg, params, dev, tuple(out_shape), average_classifiers)
        self.d_head = load_aux_head(cfg, params, "D", dev) if with_depth else None
        self.input_ch = cfg.model.input_ch
        self.with_probs = with_probs

    def forward(self, batch: Dict[str, torch.Tensor]):
        batch = {k: v for k, v in batch.items() if k != "label"}
        if "image" not in batch:
            # only a depth-only checkpoint (input_ch 1) may omit RGB: neither
            # the kernel nor its plain version reads RGB when C is 1
            if self.input_ch != 1:
                raise ValueError(
                    "serving batch needs an 'image' plane (the checkpoint's "
                    f"input_ch={self.input_ch} consumes RGB)")
            plane = batch.get("depth", batch.get("hha", batch.get("ir")))
            if plane is None:
                raise ValueError(
                    "depth-only serving batch needs a 'depth' (or 'hha'/"
                    "'ir') plane")
            batch["image"] = torch.zeros(tuple(plane.shape[:3]) + (3,),
                                         dtype=torch.uint8, device=plane.device)
        logits, _, feat = self.core(batch)
        pred = logits.argmax(-1).to(torch.int32)
        out = [pred]
        if self.d_head is not None:
            with compute_context(self.core.dtype, self.core.device):
                depth = self.d_head(feat)
            out.append(resize_to(depth, tuple(pred.shape[1:3]))[:, 0].to(torch.float32))
        if self.with_probs:
            out.append(torch.softmax(logits, dim=-1))
        return out[0] if len(out) == 1 else tuple(out)


def make_serve_fn(cfg: ExperimentConfig, params: Params, device="cuda",
                  with_depth: bool = False, average_classifiers: bool = True,
                  out_shape: Optional[Tuple[int, int]] = None,
                  with_probs: bool = False):
    """``serve(batch) -> pred[, depth][, probs]``: ``ServeModule`` with the
    parameters loaded on ``device``, fed numpy arrays or tensors, under
    ``torch.inference_mode``; results stay on ``device``. A profiled run
    marks each call as the root span ``serve.request``."""
    module = ServeModule(cfg, params, device, average_classifiers, out_shape,
                         with_probs, with_depth)

    @torch.inference_mode()
    def serve(batch):
        with span("serve.request"):
            return module(batch_to_device(batch, module.core.device))

    return serve


def _input_spec(cfg: ExperimentConfig, batch: int, extra_plane: Optional[str]):
    """(spec {name: (shape, dtype name)}, extra_plane, plane_note) of the
    artifact's raw planes: the target corpus's decode geometry, or the
    checkpoint's test_img_shape when the corpus is not reachable; the
    extra plane resolved and validated as the JAX package does."""
    from mcseg_tpu_torch.data.datasets import get_dataset

    # the corpus need not exist on the exporting host (checkpoints embed
    # the training host's data_root)
    ds = None
    if cfg.data.data_root:
        try:
            ds = get_dataset(cfg.data.tgt_dataset, cfg.data, "val")
        except (FileNotFoundError, ValueError, OSError):
            ds = None
    w, h = ds.decode_size if ds is not None else cfg.data.test_img_shape
    if extra_plane is not None and extra_plane not in ("depth", "hha", "ir", "boundary"):
        raise ValueError(f"extra_plane must be 'depth'|'hha'|'ir'|'boundary', "
                         f"got {extra_plane!r}")
    input_ch = cfg.model.input_ch
    samples = getattr(ds, "samples", None) if ds is not None else None
    plane_note = None
    spec = {}
    if input_ch != 1:
        spec["image"] = ((batch, h, w, 3), "uint8")
    if input_ch == 7:
        # the boundary plane is always read; the HHA source follows the
        # hha-vs-depth rule of input_ch 6
        spec["boundary"] = ((batch, h, w), "uint8")
        if extra_plane is None:
            extra_plane = "depth" if cfg.data.hha_on_device else "hha"
        if extra_plane == "depth":
            spec["depth"] = ((batch, h, w), "float32")
        elif extra_plane == "hha":
            spec["hha"] = ((batch, h, w, 3), "uint8")
        else:
            raise ValueError(
                "input_ch=7 takes extra_plane 'depth'|'hha' (the boundary "
                f"plane is implicit), got {extra_plane!r}")
    if input_ch in (1, 4, 6):
        if extra_plane == "ir" and input_ch == 6:
            raise ValueError(
                "extra_plane='ir' is only valid for input_ch 1/4 — the "
                "input_ch=6 preprocess consumes HHA or raw depth")
        if extra_plane == "boundary" and input_ch != 4:
            raise ValueError(
                "extra_plane='boundary' is only valid for input_ch 4 "
                "(rgb+boundary) or implicit in input_ch 7")
        if extra_plane is None:
            if input_ch == 6:
                extra_plane = "depth" if cfg.data.hha_on_device else "hha"
            elif cfg.data.tgt_dataset.lower() == "ir":
                # the preprocess prefers raw depth over IR when the corpus
                # has both; unreachable -> depth, flagged in the manifest
                if samples:
                    extra_plane = "depth" if "depth" in samples[0] else "ir"
                else:
                    extra_plane = "depth"
                    plane_note = (
                        "tgt corpus 'ir' was not reachable at export time; "
                        "defaulted to the raw-depth plane (the training "
                        "preference when depth exists) — pass "
                        "extra_plane='ir' if training consumed IR")
            else:
                # the plane the preprocess would read (depth > hha > ir >
                # boundary); unreachable -> depth
                extra_plane = "depth"
                if samples:
                    extra_plane = next((c for c in ("depth", "hha", "ir", "boundary")
                                        if c in samples[0]), "depth")
        if extra_plane == "depth":
            spec["depth"] = ((batch, h, w), "float32")
        elif extra_plane == "hha":
            spec["hha"] = ((batch, h, w, 3), "uint8")
        else:  # 'ir' or 'boundary': one uint8 plane
            spec[extra_plane] = ((batch, h, w), "uint8")
    elif extra_plane is not None and input_ch == 3:
        raise ValueError(
            f"extra_plane={extra_plane!r} conflicts with "
            f"input_ch={input_ch} (RGB-only checkpoint)")
    return spec, extra_plane, plane_note


def export_serving(cfg: ExperimentConfig, params: Params, out_path: str,
                   batch: int = 1, device="cuda", average_classifiers: bool = True,
                   out_shape: Optional[Tuple[int, int]] = None,
                   with_probs: bool = False, extra_plane: Optional[str] = None,
                   with_depth: Optional[bool] = None) -> dict:
    """Export the serving path to ``out_path`` (+ a ``.json`` manifest) for
    ``device``; returns the manifest.

    The artifact takes the raw-plane batch dict at the fixed ``batch`` and
    the checkpoint's decode geometry (static shapes: export several sizes
    for a bucketing server). ``extra_plane``: the non-RGB plane it ingests
    when input_ch needs one — 'depth' (float32 metres), 'hha' (uint8
    precomputed HHA), 'ir' (uint8) or 'boundary' (uint8). The default
    resolves from the checkpoint: 'hha' for input_ch 6 trained on HHA files
    (hha_on_device False), for the IR corpus what it holds, else 'depth'.
    A multitask checkpoint also returns its depth map unless
    ``with_depth`` is False."""
    dev = resolve_device(device)
    if with_depth is None:
        with_depth = "D" in params
    spec, extra_plane, plane_note = _input_spec(cfg, batch, extra_plane)
    module = ServeModule(cfg, params, dev, average_classifiers, out_shape,
                         with_probs, with_depth)
    example = {k: torch.zeros(shape, dtype=_DTYPES[dt], device=dev)
               for k, (shape, dt) in spec.items()}
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    buf = io.BytesIO()
    with warnings.catch_warnings():
        # channels_last weights are not "complete" in the archive's sense;
        # it stores each one's whole storage with its strides, as wanted
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(program, buf)
    blob = buf.getvalue()
    # tmp + os.replace (the checkpoint's atomicity contract): a crash
    # mid-export never leaves a truncated artifact, or an artifact and a
    # manifest that disagree
    with open(out_path + ".tmp", "wb") as f:
        f.write(blob)
    os.replace(out_path + ".tmp", out_path)
    th, tw = out_shape or (cfg.data.test_img_shape[1], cfg.data.test_img_shape[0])
    manifest = {
        "format": "torch.export",
        "device": dev.type,
        "torch_version": torch.__version__,
        "input_spec": {k: {"shape": list(shape), "dtype": dt}
                       for k, (shape, dt) in spec.items()},
        "output": f"int32 train-id map [B,{th},{tw}]"
        + (" + float32 depth meters" if with_depth else "")
        + (" + float32 softmax probs" if with_probs else ""),
        # ordered names of the artifact's outputs: hosts parse tuples by them
        "outputs": (["pred"] + (["depth"] if with_depth else [])
                    + (["probs"] if with_probs else [])),
        "n_class": cfg.model.n_class,
        "net": cfg.model.net,
        "input_ch": cfg.model.input_ch,
        "extra_plane": extra_plane,
        "average_classifiers": average_classifiers,
        "bytes": len(blob),
    }
    if extra_plane == "depth" and cfg.model.input_ch in (1, 4):
        manifest["note"] = (
            "raw-depth normalization uses the per-batch depth max (training "
            "semantics): multi-image batches couple predictions to their "
            "batchmates — export batch=1 for per-image determinism")
    if plane_note:
        manifest["plane_note"] = plane_note
    with open(out_path + ".json.tmp", "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(out_path + ".json.tmp", out_path + ".json")
    return manifest


def load_serving(path: str, device=None):
    """Load an artifact of ``export_serving``; returns ``call(batch)``,
    which takes the manifest's planes as numpy arrays or tensors and
    returns tensors on the artifact's device, as the exported function
    returns them (pred alone, or a tuple in the manifest's ``outputs``
    order). ``device``: the device the caller expects (default: the
    manifest's); raises when it differs from the one the artifact was
    exported for, or when that is CUDA and this process has none."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    dev = resolve_device(manifest["device"])
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"{path} was exported for {dev.type!r}, not {device!r}; "
                         "export it again for that device")
    with open(path, "rb") as f:  # a file object: the name need not end in .pt2
        module = torch.export.load(f).module()
    names = list(manifest["input_spec"])

    @torch.inference_mode()
    def call(batch):
        return module(batch_to_device({k: batch[k] for k in names}, dev))

    call.manifest = manifest
    return call
