#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mcseg_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from the
sources in the checkout (nvcc, sm_90a), holds every kernel against its plain
PyTorch version on the card, drives the serving path at full width
(DRN-D-38, RGB+HHA from raw depth, 40 classes, 640x480, batch 8, bf16,
random weights from a seed) through ``make_serve_fn`` and ``evaluate``, then
the MCD training path at the same width (``num_k`` 4, synthetic ->
synthetic_shifted) through the training iteration and ``train_adapt``, then
the multitask trainer (segmentation plus depth and boundary heads, MCD)
at the same width through its iteration, ``train_multitask``, the tester
and depth serving, then the reference commands (``cli.adapt_train``,
``adapt_test``, ``source_train``, ``source_test``, ``multitask_train``)
through their ``main``, then one MCD configuration of every other trunk,
fusion mode and channel stack the flags accept (FCN8s on VGG16 and PSPNet
among them, each also scored by one ``evaluate`` batch), then the host
side of a real run (phase ``corpus``): it writes on-disk corpora with its
own PNG writer, measures host decode against the card's rate, and trains
from the files through decode threads and prefetch, the card-resident
corpus and the disk cache, with an async epoch checkpoint, an
``--input_ch 7`` iteration and a ``--submit_dir`` run; then the deployment
path (phase ``deploy``): the serving model exported with ``torch.export``
at batch 8 and 1, each artifact loaded in a fresh process, the batch-8
artifact held against in-process serving and timed beside it, the kernel
counted and profiled inside the artifact, ``bench_serving``, one HTTP
round trip through ``serve_http``, the tester's ``--outdir --saves_prob``
dumps and a ``--tb_dir`` iteration; then checkpoint interop and the result
tools (phase ``interop``): a reference-format torch checkpoint and a bare
trunk made from the seed-0 weights imported by ``import_torch``,
``parity_eval`` on an NYU-layout val split it writes, ``evaluate_preds``
and ``make_result_sheet`` on the dumps, the state through a JAX
``.msgpack`` and back, ``adapt_test`` of the ``.msgpack`` prefix and
``summarize_run`` of a short run; and it checks that each path launched
the kernels. Every phase prints one JSON line
and any failure raises (exit code != 0), a ptxas spill included. Kernel
times are L2-cold, as the serving path finds its inputs: each timing
rotates over input sets that together move 3x the 50 MB L2, and a reading
above 1.05x of the card's bound raises as a timing fault. The last lines
are the kernel table, the card's name and power limit as nvidia-smi reports
them, and ``{"ok": true, "device": {...}}``.

It exits non-zero without printing a result when CUDA is unavailable, and
when ``mcseg_tpu_torch`` is not next to this file.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # CUDA cores, no tensor cores
H100_BF16_FLOPS = 989e12  # dense tensor cores
H100_L2_BYTES = 50 * 2**20
COLD_BYTES = 3 * H100_L2_BYTES  # what a kernel timing rotates through
KERNEL_SRC = "mcseg_tpu_torch/csrc/normalize_stack.cu"
KERNEL_REPLACES = "mcseg_tpu/ops/pallas/normalize.py:84"
B, H, W = 8, 480, 640
N_REQUESTS = 6  # the first one also warms cuDNN up
TRAIN_WARMUP, TRAIN_TIMED = 2, 5  # MCD iterations
# card against CPU, one float32 iteration at batch 2, 48x64 (_card_vs_cpu,
# _iteration_errors). Each bound is 5-7x the difference measured on an
# H100 80GB HBM3 (700 W): losses 3.0e-4, updates 6.7e-3, parameters
# 9.3e-6, running means 1.4e-3 std, running variances 4.4e-3; the CPU's own
# float32 iteration differs from float64 by as much (4.4e-4, 7.0e-3, 9.6e-6,
# 1.2e-3, 4.6e-3): tiny-batch BN amplifies float32 rounding.
CARD_VS_CPU_BOUNDS = {"loss": 2e-3, "update": 4e-2, "param": 5e-5,
                      "running_mean": 1e-2, "running_var": 3e-2}
DEVICE = "cuda"  # the card the training phase runs on
MT_DEPTH_WEIGHT, MT_BOUNDARY_WEIGHT = 0.5, 1.0  # the multitask phase's loss weights


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_time_ms(fns, runs=50, per_run=10):
    """Median over ``runs`` of the device time per call, by CUDA events
    around ``per_run`` back-to-back calls. ``fns`` is one callable or a list
    called in turn; each result is held until that callable's next call, so
    outputs rotate too. Rotating over sets of buffers larger together than
    the L2 makes every call find its data cold. A sleep kernel queued first
    keeps the card busy while the host enqueues, so host launch overhead does
    not enter the device time."""
    import torch

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    held = [None] * len(fns)
    calls = 0

    def call_next():
        nonlocal calls
        i = calls % len(fns)
        held[i] = fns[i]()
        calls += 1

    for _ in range(max(3, len(fns))):
        call_next()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)
        start.record()
        for _ in range(per_run):
            call_next()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def phase_env():
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         tf32={"cudnn": False, "matmul": False},
         note="TF32 off so that float32 comparisons are float32")
    return smi.splitlines()[0]


def phase_build():
    from mcseg_tpu_torch.utils.cuda_build import build

    t0 = time.perf_counter()
    logs = build(["normalize_stack"])
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    emit("build", seconds=round(secs, 3), sources=sorted(logs), ptxas=ptxas)
    spills = [ln for lines in ptxas.values() for ln in lines
              if re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    if spills:
        raise AssertionError(f"ptxas reports spills: {spills}")


def _kernel_case(input_ch, rgb_float, out_dtype, flip_pattern, seed=0):
    import torch

    from mcseg_tpu_torch.ops.normalize import (
        fused_normalize_stack, normalize_stack_reference)

    e = {3: 0, 6: 3, 4: 1, 1: 1, 7: 4}[input_ch]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flip = torch.tensor([flip_pattern[i % len(flip_pattern)] for i in range(B)],
                        dtype=torch.int32, device="cuda")

    def make_args():
        rgb = torch.randint(0, 256, (B, H, W, 3), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.uint8)
        if rgb_float:
            rgb = rgb.to(torch.float32) / 255.0
        extra = (torch.rand((B, H, W, e), generator=gen, device="cuda")
                 if e else None)
        return rgb, extra, flip, input_ch, out_dtype

    args = make_args()
    before = fused_normalize_stack.launches
    got = fused_normalize_stack(*args)
    want = normalize_stack_reference(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    max_err = float(err.max())
    if out_dtype == torch.float32:
        ok = max_err <= 1e-6
    else:  # equal up to one bf16 ulp (8 significant bits)
        ok = bool((err <= want.float().abs() * 2.0 ** -7).all())
    if not ok:
        raise AssertionError(f"normalize_stack input_ch={input_ch} rgb_float={rgb_float} "
                             f"out={out_dtype}: max abs err {max_err}")
    out_bytes = 2 if out_dtype == torch.bfloat16 else 4
    n_px = B * H * W
    rgb_bytes = 0 if input_ch == 1 else args[0].numel() * args[0].element_size()  # 1: unread
    nbytes = rgb_bytes + n_px * e * 4 + B * 4 + n_px * input_ch * out_bytes
    flops = n_px * (input_ch * 2 + (0 if rgb_float or input_ch == 1 else 3))
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    # L2-cold, as the serving caller finds it (HHA and the trunk run between
    # two launches): rotate over input sets that together move >= 3x the L2
    sets = [args] + [make_args() for _ in range(max(2, -(-COLD_BYTES // nbytes)) - 1)]
    kernel_ms = gpu_time_ms([lambda a=a: fused_normalize_stack(*a) for a in sets])
    plain_ms = gpu_time_ms([lambda a=a: normalize_stack_reference(*a) for a in sets])
    share = bound_ms / kernel_ms
    if share > 1.05:
        raise AssertionError(f"normalize_stack input_ch={input_ch}: {kernel_ms} ms is "
                             f"{share:.2f}x its {bound_ms} ms bound; the timing is wrong")
    return {
        "input_ch": input_ch, "rgb": "float32" if rgb_float else "uint8",
        "out": "bfloat16" if out_dtype == torch.bfloat16 else "float32",
        "flip": flip.tolist(), "max_abs_err": max_err,
        "launches": fused_normalize_stack.launches - before,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "share_of_bound": share, "gb_per_s": nbytes / kernel_ms / 1e6,
        "bytes": nbytes, "cold_sets": len(sets),
    }


def phase_kernels():
    import torch

    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack

    cases = []
    before = fused_normalize_stack.launches
    for input_ch in (3, 6, 4, 1):
        for rgb_float in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                cases.append(_kernel_case(input_ch, rgb_float, out_dtype, (0, 1)))
    # the training path's case: float32 RGB + HHA after the crop, bf16 out,
    # mixed flips (one of the cases above)
    train_case = next(c for c in cases if c["input_ch"] == 6 and c["rgb"] == "float32"
                      and c["out"] == "bfloat16")
    # the serving path's own case: uint8 RGB + HHA, bf16 out, no flip
    main = _kernel_case(6, False, torch.bfloat16, (0,), seed=1)
    cases.append(main)
    # input_ch 7 (RGB + HHA + boundary) as training feeds it: float32 RGB
    # after the crop, bf16 out, mixed flips; bf16 results equal the plain
    # version's, so it is held within 1e-6
    c7 = _kernel_case(7, True, torch.bfloat16, (0, 1), seed=2)
    if c7["max_abs_err"] > 1e-6:
        raise AssertionError(f"normalize_stack input_ch=7: max abs err {c7['max_abs_err']}")
    cases.append(c7)
    emit("kernels", kernels=[{"name": "fused_normalize_stack", "route": "cuda",
                              "source": KERNEL_SRC, "replaces": KERNEL_REPLACES,
                              "shape": [B, H, W], "cases": cases}],
         comparison_launches=fused_normalize_stack.launches - before)
    return main, train_case, c7


def _serve_config(dtype):
    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig

    return ExperimentConfig(
        model=ModelConfig(net="drn_d_38", input_ch=6, n_class=40, dtype=dtype,
                          upsample="convt"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=B, test_img_shape=(W, H), input_ch=6,
                        hha_on_device=True))


def _breakdown(cfg, params, request):
    """Device time of the serving path's stages on one request (CUDA
    events; the stages run eagerly one after another as in serving)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mcseg_tpu_torch.core.device import compute_context
    from mcseg_tpu_torch.eval.tester import _averaged_head_params
    from mcseg_tpu_torch.models.factory import get_models
    from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.ops.upsample import upsample_bilinear_convt

    dev = torch.device("cuda")
    g, head, _ = get_models(cfg.model)
    g.load_state_dict(params["G"])
    head.load_state_dict(_averaged_head_params(params["F1"], params["F2"], torch.bfloat16))
    g, head = (m.to(dev).to(memory_format=torch.channels_last).eval() for m in (g, head))
    image = torch.as_tensor(request["image"]).to(dev)
    depth = torch.as_tensor(request["depth"]).to(dev)
    flip = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        extra = depth_to_hha_batch(depth) / 255.0
        img = fused_normalize_stack(image, extra, flip, 6, torch.bfloat16)
        x = img.permute(0, 3, 1, 2)
        with compute_context(torch.bfloat16, dev):
            feat = g(x)

        def head_argmax():
            with compute_context(torch.bfloat16, dev):
                return head(feat).argmax(1)

        def trunk():
            with compute_context(torch.bfloat16, dev):
                return g(x)

        with compute_context(torch.bfloat16, dev):
            score = head.score(feat)
            logits = head(feat)
        with FlopCounterMode(display=False) as counter:
            trunk()
        trunk_ms = gpu_time_ms(trunk, runs=10, per_run=2)
        trunk_tflop = counter.get_total_flops() / 1e12
        return {
            "trunk_ms": trunk_ms,
            "trunk_tflop": trunk_tflop,
            "trunk_tflop_per_s": trunk_tflop / trunk_ms * 1e3,
            "trunk_share_of_bf16_peak": trunk_tflop / trunk_ms * 1e3 / H100_BF16_FLOPS * 1e12,
            "hha_ms": gpu_time_ms(lambda: depth_to_hha_batch(depth) / 255.0, runs=10, per_run=2),
            "normalize_ms": gpu_time_ms(
                lambda: fused_normalize_stack(image, extra, flip, 6, torch.bfloat16),
                runs=10, per_run=2),
            "head_upsample_argmax_ms": gpu_time_ms(head_argmax, runs=10, per_run=2),
            "of_which_convt_upsample_ms": gpu_time_ms(
                lambda: upsample_bilinear_convt(score, 8), runs=10, per_run=2),
            "of_which_argmax_ms": gpu_time_ms(lambda: logits.argmax(1), runs=10, per_run=2),
        }


def phase_serve(smi_line):
    import torch

    from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.models.factory import init_models
    from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
    from mcseg_tpu_torch.ops.normalize import (
        fused_normalize_stack, normalize_stack_reference)
    from mcseg_tpu_torch.ops.preprocess import make_eval_preprocess

    cfg = _serve_config("bfloat16")
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    ds = get_dataset("synthetic_shifted", cfg.data, "val")
    requests = []
    for r in range(N_REQUESTS):
        raw = stack_samples(ds, range(r * B, (r + 1) * B))
        requests.append({"image": raw["image"], "depth": raw["depth"]})

    serve = make_serve_fn(cfg, params, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fused_normalize_stack.launches = 0  # count only the main path from here
    times = []
    for i, req in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = serve(req)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if fused_normalize_stack.launches != i + 1:
            raise AssertionError(f"request {i}: normalize kernel launched "
                                 f"{fused_normalize_stack.launches} times in total")
        if tuple(pred.shape) != (B, H, W) or pred.dtype != torch.int32:
            raise AssertionError(f"pred {tuple(pred.shape)} {pred.dtype}")
        lo, hi = int(pred.min()), int(pred.max())
        if lo < 0 or hi >= cfg.model.n_class:
            raise AssertionError(f"pred values outside [0, {cfg.model.n_class}): {lo}..{hi}")
    launches = fused_normalize_stack.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times[1:])

    # one request in float32: the kernel's stacked input equals the plain
    # version on the same preprocessed planes
    cfg32 = _serve_config("float32")
    dev = torch.device("cuda")
    batch = {k: torch.as_tensor(v).to(dev) for k, v in requests[0].items()}
    with torch.inference_mode():
        stacked, _ = make_eval_preprocess(cfg32.data, torch.float32)(batch)
        extra = depth_to_hha_batch(batch["depth"]) / 255.0
        plain = normalize_stack_reference(batch["image"], extra,
                                          torch.zeros(B, dtype=torch.int32, device=dev), 6)
    stack_err = float((stacked - plain).abs().max())
    if stack_err > 1e-6:
        raise AssertionError(f"fp32 stacked input differs from plain version by {stack_err}")
    pred32 = make_serve_fn(cfg32, params, device="cuda")(requests[0])
    pred16 = serve(requests[0])
    agree_bf16_fp32 = float((pred32 == pred16).float().mean())

    # a small input against the plain CPU path (float32 both sides, TF32 off)
    small = {k: v[:2, :48, :64].copy() for k, v in requests[0].items()}
    cfg_small = dataclasses.replace(
        cfg32, data=dataclasses.replace(cfg32.data, test_img_shape=(64, 48)))
    p_gpu = make_serve_fn(cfg_small, params, device="cuda")(small).cpu().numpy()
    p_cpu = make_serve_fn(cfg_small, params, device="cpu")(small).numpy()
    agree_small = float((p_gpu == p_cpu).mean())
    if agree_small < 0.999:
        raise AssertionError(f"card vs CPU preds agree on only {agree_small:.4f} of pixels")

    breakdown = _breakdown(cfg, params, requests[1])
    emit("serve", net=cfg.model.net, input_ch=6, n_class=40, batch=B, hw=[H, W],
         dtype="bfloat16", requests=len(requests), launches=launches,
         ms_per_request=ms, images_per_s=B / ms * 1e3,
         ms_per_request_all=times, peak_mem_gb=peak_gb,
         fp32_stack_max_abs_err=stack_err, pred_agree_bf16_vs_fp32=agree_bf16_fp32,
         pred_agree_card_vs_cpu_small=agree_small,
         breakdown_ms=breakdown, card=smi_line,
         note="random weights; card numbers beside the card's name and power limit")
    return launches


def phase_eval():
    import numpy as np
    import torch

    from mcseg_tpu_torch.data.datasets import get_dataset
    from mcseg_tpu_torch.eval.tester import evaluate
    from mcseg_tpu_torch.models.factory import init_models
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack

    cfg = _serve_config("bfloat16")
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    ds = get_dataset("synthetic_shifted", cfg.data, "val")
    fused_normalize_stack.launches = 0
    t0 = time.perf_counter()
    miou, hist, _ = evaluate(params, cfg, dataset=ds, max_batches=2,
                             print_table=False, device="cuda")
    secs = time.perf_counter() - t0
    n_valid = sum(int((ds[i]["label"] != 0).sum()) for i in range(2 * B))  # raw 0 = void
    if int(hist.sum()) != n_valid:
        raise AssertionError(f"hist counts {int(hist.sum())} pixels, labels have {n_valid}")
    if not np.isfinite(miou):
        raise AssertionError(f"mIoU {miou}")
    if fused_normalize_stack.launches != 2:
        raise AssertionError(f"eval launched the kernel {fused_normalize_stack.launches} times")
    emit("eval", batches=2, batch=B, miou=miou, hist_pixels=int(hist.sum()),
         launches=fused_normalize_stack.launches, seconds=secs,
         note="random weights: the mIoU value is meaningless, the plumbing is checked")


def _train_config(dtype, hw=None, batch=None, net="drn_d_38", input_ch=6,
                  fusion="single", **train_kw):
    """BASELINE config 4's training iteration (``bench.py:151``) on the
    synthetic corpora: DRN-D-38, RGB+HHA, 40 classes, convt heads, SGD
    (momentum 0.9, wd 2e-5) at lr 1e-3 with the poly schedule, num_k 4;
    ``net``, ``input_ch`` and ``fusion`` pick another family."""
    from mcseg_tpu_torch.core.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)

    hw, batch = hw or (H, W), batch or B
    return ExperimentConfig(
        model=ModelConfig(net=net, input_ch=input_ch, n_class=40, dtype=dtype,
                          upsample="convt", fusion=fusion),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=batch, train_img_shape=(hw[1], hw[0]),
                        test_img_shape=(hw[1], hw[0]), input_ch=input_ch,
                        hha_on_device=True),
        train=TrainConfig(lr=1e-3, num_k=4, max_steps=100_000, seed=0, **train_kw))


def _raw_pair(cfg, n, device):
    """The first ``n`` train samples of source and target, on ``device``."""
    import torch

    from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples

    out = []
    for name in (cfg.data.src_dataset, cfg.data.tgt_dataset):
        raw = stack_samples(get_dataset(name, cfg.data, "train"), range(n))
        out.append({k: torch.as_tensor(v).to(device) for k, v in raw.items()})
    return out


def _snapshot(state):
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in state.modules().items()}


def _unchanged(before, after):
    """The floating-point tensors of every module that training left equal."""
    import torch

    return [f"{n}.{k}" for n, sd in before.items() for k, v in sd.items()
            if v.is_floating_point() and torch.equal(v, after[n][k])]


def _small_iteration(dtype, device, params, **family):
    """One iteration at batch 2, 48x64 of the full-width trunk (DRN-D-38
    unless ``family`` names another) from ``params``: (metrics, weights
    before, weights after), the weights on the CPU."""
    import torch

    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    cfg = _train_config(dtype, hw=(48, 64), batch=2, **family)
    state = create_train_state(cfg.model, cfg.train, 0, device, params=params)
    before = _snapshot(state)
    src, tgt = _raw_pair(cfg, 2, device)
    metrics = make_adapt_iteration(cfg)(state, src, tgt)

    def cpu(snap):
        return {n: {k: v.cpu().double() for k, v in sd.items() if v.is_floating_point()}
                for n, sd in snap.items()}

    return {k: float(v) for k, v in metrics.items()}, cpu(before), cpu(_snapshot(state))


def _iteration_errors(got, ref):
    """How far iteration ``got`` is from ``ref``: losses relative; each
    module's parameter update (after - before) and its parameters by
    relative L2 norm; BN running means in units of the feature's standard
    deviation (a mean near 0 has no scale of its own), running variances
    relative, both the largest over elements."""
    (m_got, b_got, a_got), (m_ref, b_ref, a_ref) = got, ref
    losses = ("loss_source", "loss_b", "loss_dis", "loss_depth", "loss_boundary")
    err = {"loss": max(abs(m_got[k] - m_ref[k]) / abs(m_ref[k]) for k in losses if k in m_ref),
           "update": 0.0, "param": 0.0, "running_mean": 0.0, "running_var": 0.0}
    for n, sd in a_ref.items():
        d_num = d_den = p_num = p_den = 0.0
        for k, want in sd.items():
            if k.endswith("running_mean"):
                z = (a_got[n][k] - want).abs() / sd[k.replace("mean", "var")].sqrt()
                err["running_mean"] = max(err["running_mean"], float(z.max()))
            elif k.endswith("running_var"):
                rel = (a_got[n][k] - want).abs() / want
                err["running_var"] = max(err["running_var"], float(rel.max()))
            else:
                upd_got, upd_ref = a_got[n][k] - b_got[n][k], want - b_ref[n][k]
                d_num += float(((upd_got - upd_ref) ** 2).sum())
                d_den += float((upd_ref ** 2).sum())
                p_num += float(((a_got[n][k] - want) ** 2).sum())
                p_den += float((want ** 2).sum())
        err["update"] = max(err["update"], (d_num / d_den) ** 0.5)
        err["param"] = max(err["param"], (p_num / p_den) ** 0.5)
    return err


def _card_vs_cpu(**family):
    """One float32 iteration (TF32 off) on the card and on the CPU from the
    same weights, batches and draws, each also held against a float64 CPU
    iteration: the card's error from float64 next to the CPU's own float32
    error shows how much of the card-CPU difference is float32 rounding.
    Returns (report, failures against CARD_VS_CPU_BOUNDS)."""
    import torch

    from mcseg_tpu_torch.models.factory import init_models

    params = init_models(_train_config("float32", **family).model,
                         torch.Generator().manual_seed(0))
    card32 = _small_iteration("float32", DEVICE, params, **family)
    cpu32 = _small_iteration("float32", "cpu", params, **family)
    cpu64 = _small_iteration("float64", "cpu", params, **family)
    report = {"card_fp32_vs_cpu_fp32": _iteration_errors(card32, cpu32),
              "card_fp32_vs_cpu_fp64": _iteration_errors(card32, cpu64),
              "cpu_fp32_vs_cpu_fp64": _iteration_errors(cpu32, cpu64),
              "bounds": CARD_VS_CPU_BOUNDS, "metrics_card": card32[0],
              "metrics_cpu": cpu32[0]}
    failures = [f"{k} {report['card_fp32_vs_cpu_fp32'][k]:.3g} > {b}"
                for k, b in CARD_VS_CPU_BOUNDS.items()
                if not report["card_fp32_vs_cpu_fp32"][k] <= b]
    return report, failures


def _train_breakdown(iterate, state, src, tgt):
    """Device time of each stage of one iteration, by CUDA events recorded
    as the host reaches the end of each stage (median of 3 iterations);
    a stage's time includes any wait of the card for the host inside it."""
    import torch

    names = ("preprocess", "A", "B", "C")
    per_stage = {n: [] for n in names}
    for _ in range(3):
        events = [torch.cuda.Event(enable_timing=True)]
        events[0].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        iterate(state, src, tgt, mark)
        torch.cuda.synchronize()
        for n, a, b in zip(names, events, events[1:]):
            per_stage[n].append(a.elapsed_time(b))
    med = {n: statistics.median(v) for n, v in per_stage.items()}
    return {"preprocess_both_batches": med["preprocess"], "step_a": med["A"],
            "step_b": med["B"], "step_c_x4": med["C"]}


def _train_profile(iterate, state, src, tgt, top=8):
    """One iteration under ``torch.profiler``: the card's busy time (the sum
    of kernel and copy times on its one stream) against the iteration's
    wall time under the profiler, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iterate(state, src, tgt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only: an operator's row repeats its kernels' time
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA and r.self_device_time_total > 0]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_kernels": [{"name": r.key[:120], "ms": r.self_device_time_total / 1e3,
                             "calls": r.count} for r in rows[:top]]}


def _convt_fwd_bwd_ms(state, src, cfg):
    """The convt upsample of one head, forward plus backward, at the step's
    shape: [B, 40, H/8, W/8] bf16 scores -> [B, 40, H, W]."""
    import torch

    from mcseg_tpu_torch.core.device import compute_context
    from mcseg_tpu_torch.ops.preprocess import make_train_preprocess
    from mcseg_tpu_torch.ops.upsample import upsample_bilinear_convt

    dev = torch.device(DEVICE)
    flip = torch.zeros(B, dtype=torch.int32)
    img, _ = make_train_preprocess(cfg.data, torch.bfloat16)(src, flip, flip, flip)
    with torch.no_grad(), compute_context(torch.bfloat16, dev):
        score = state.f1.score(state.g(img.permute(0, 3, 1, 2)))
    score = score.detach().requires_grad_(True)
    cot = torch.randn((B, 40, H, W), device=dev, dtype=score.dtype)

    def fwd_bwd():
        up = upsample_bilinear_convt(score, 8)
        up.backward(cot)
        return up

    fwd = gpu_time_ms(lambda: upsample_bilinear_convt(score.detach(), 8), runs=5, per_run=2)
    return fwd, gpu_time_ms(fwd_bwd, runs=5, per_run=2)


def _run_loop(smi_line):
    """``train_adapt`` for 2 iterations at full width with a checkpoint per
    epoch, then ``evaluate`` of that checkpoint for one batch."""
    import tempfile

    import numpy as np

    from mcseg_tpu_torch.eval.tester import evaluate
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.loops import train_adapt
    from mcseg_tpu_torch.utils.checkpoint import load_params
    from mcseg_tpu_torch.utils.logging import JsonlLogger

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="train_") as out_dir:
        cfg = _train_config("bfloat16", epochs=1, out_dir=out_dir, log_every=1)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_samples=2 * B))
        fused_normalize_stack.launches = 0
        t0 = time.perf_counter()
        state = train_adapt(cfg, logger=JsonlLogger(os.path.join(out_dir, "log.jsonl"), echo=False),
                            device=DEVICE)
        loop_s = time.perf_counter() - t0
        loop_launches = fused_normalize_stack.launches
        if state.step != 2 or loop_launches != 4:
            raise AssertionError(f"train_adapt: {state.step} iterations, "
                                 f"{loop_launches} kernel launches")
        with open(os.path.join(out_dir, "log.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        params, ckpt_cfg = load_params(os.path.join(out_dir, "last"))
        fused_normalize_stack.launches = 0
        miou, hist, _ = evaluate(params, ckpt_cfg, max_batches=1, print_table=False,
                                 device=DEVICE)
        if fused_normalize_stack.launches != 1 or not np.isfinite(miou) or hist.sum() == 0:
            raise AssertionError(f"evaluate of the checkpoint: mIoU {miou}, "
                                 f"{fused_normalize_stack.launches} launches")
        ckpt_mb = os.path.getsize(os.path.join(out_dir, "last.pt")) / 1e6
    return {"iterations": state.step, "seconds": loop_s, "launches": loop_launches,
            "logged": logged, "checkpoint_mb": ckpt_mb, "eval_miou": miou,
            "eval_launches": 1, "card": smi_line,
            "note": "includes host decode of the synthetic corpora and two checkpoints"}


def phase_train(smi_line):
    import math

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    cfg = _train_config("bfloat16")
    state = create_train_state(cfg.model, cfg.train, 0, DEVICE)
    src, tgt = _raw_pair(cfg, B, DEVICE)  # staged on the card before timing
    iterate = make_adapt_iteration(cfg)
    before = _snapshot(state)
    for _ in range(TRAIN_WARMUP):
        iterate(state, src, tgt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_normalize_stack.launches = 0  # count only the main path from here
    times, metrics = [], []
    for i in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = iterate(state, src, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if fused_normalize_stack.launches != 2 * (i + 1):
            raise AssertionError(f"iteration {i}: normalize kernel launched "
                                 f"{fused_normalize_stack.launches} times in total")
    launches = fused_normalize_stack.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bad = [m for m in metrics if not all(math.isfinite(v) for v in m.values())]
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    unchanged = _unchanged(before, _snapshot(state))
    if unchanged:
        raise AssertionError(f"not updated by training: {unchanged[:10]}")
    ms = statistics.median(times)

    breakdown = _train_breakdown(iterate, state, src, tgt)
    convt_fwd, convt_fwd_bwd = _convt_fwd_bwd_ms(state, src, cfg)
    breakdown["convt_upsample_one_head_fwd"] = convt_fwd
    breakdown["convt_upsample_one_head_fwd_bwd"] = convt_fwd_bwd
    with FlopCounterMode(display=False) as counter:
        iterate(state, src, tgt)
    trunk_tflop = sum(counter.get_flop_counts()["DRN"].values()) / 1e12
    profile = _train_profile(iterate, state, src, tgt)
    card_vs_cpu, failures = _card_vs_cpu()
    emit("train", net=cfg.model.net, input_ch=6, n_class=40, batch=B, hw=[H, W],
         dtype="bfloat16", num_k=cfg.train.num_k, upsample="convt",
         warmup=TRAIN_WARMUP, iterations=TRAIN_TIMED, launches=launches,
         launches_per_iteration=launches / TRAIN_TIMED,
         ms_per_iteration=ms, ms_per_iteration_all=times,
         images_per_s=2 * B / ms * 1e3, peak_mem_gb=peak_gb, metrics=metrics,
         breakdown_ms=breakdown, profile=profile, trunk_tflop_per_iteration=trunk_tflop,
         trunk_share_of_bf16_peak=trunk_tflop / ms * 1e3 / H100_BF16_FLOPS * 1e12,
         card_vs_cpu=card_vs_cpu, loop=_run_loop(smi_line), card=smi_line,
         note="device rate: raw batches staged on the card; images counted as "
              "source plus target (2 x batch) per iteration; random weights")
    if failures:
        raise AssertionError(f"card vs CPU float32 iteration: {failures}")
    return launches, ms


def _multitask_loop(smi_line):
    """``train_multitask`` (MCD, both heads) for 2 iterations at full width
    with a checkpoint per epoch, then ``evaluate`` of that checkpoint for
    one batch, whose table must carry the depth and boundary lines, then
    one depth-serving request of it."""
    import tempfile

    import numpy as np
    import torch

    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.eval.tester import evaluate
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.loops import train_multitask
    from mcseg_tpu_torch.utils.checkpoint import load_params
    from mcseg_tpu_torch.utils.logging import JsonlLogger

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="mt_") as out_dir:
        cfg = _train_config("bfloat16", epochs=1, out_dir=out_dir, log_every=1)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, max_samples=2 * B))
        fused_normalize_stack.launches = 0
        t0 = time.perf_counter()
        state = train_multitask(
            cfg, MT_DEPTH_WEIGHT, MT_BOUNDARY_WEIGHT, adapt=True,
            logger=JsonlLogger(os.path.join(out_dir, "log.jsonl"), echo=False), device=DEVICE)
        loop_s = time.perf_counter() - t0
        loop_launches = fused_normalize_stack.launches
        if state.step != 2 or loop_launches != 4:
            raise AssertionError(f"train_multitask: {state.step} iterations, "
                                 f"{loop_launches} kernel launches")
        with open(os.path.join(out_dir, "log.jsonl")) as f:
            logged = [json.loads(ln) for ln in f]
        params, ckpt_cfg = load_params(os.path.join(out_dir, "last"))
        if sorted(params) != ["B", "D", "F1", "F2", "G"]:
            raise AssertionError(f"multitask checkpoint holds {sorted(params)}")
        fused_normalize_stack.launches = 0
        t0 = time.perf_counter()
        miou, hist, table = evaluate(params, ckpt_cfg, max_batches=1, print_table=False,
                                     device=DEVICE)
        eval_s = time.perf_counter() - t0
        aux_lines = [ln for ln in table.splitlines() if ln.startswith(("depth:", "boundary"))]
        if (fused_normalize_stack.launches != 1 or not np.isfinite(miou) or hist.sum() == 0
                or len(aux_lines) != 3):
            raise AssertionError(f"evaluate of the multitask checkpoint: mIoU {miou}, "
                                 f"{fused_normalize_stack.launches} launches, lines {aux_lines}")
        ds = _raw_pair(ckpt_cfg, B, "cpu")[1]
        serve = make_serve_fn(ckpt_cfg, params, device=DEVICE, with_depth=True)
        fused_normalize_stack.launches = 0
        pred, depth = serve({"image": ds["image"], "depth": ds["depth"]})
        torch.cuda.synchronize()
        if (fused_normalize_stack.launches != 1 or depth.dtype != torch.float32
                or tuple(depth.shape) != (B, H, W) or tuple(pred.shape) != (B, H, W)
                or not bool(torch.isfinite(depth).all())):
            raise AssertionError(f"depth serving: {tuple(depth.shape)} {depth.dtype}, "
                                 f"{fused_normalize_stack.launches} launches")
        ckpt_mb = os.path.getsize(os.path.join(out_dir, "last.pt")) / 1e6
    return {"iterations": state.step, "seconds": loop_s, "launches": loop_launches,
            "logged": logged, "checkpoint_mb": ckpt_mb, "eval_miou": miou,
            "eval_seconds": eval_s, "eval_launches": 1, "eval_aux_lines": aux_lines,
            "serve_depth_m": [float(depth.min()), float(depth.max())], "serve_launches": 1,
            "card": smi_line,
            "note": "includes host decode of the synthetic corpora and two checkpoints"}


def phase_multitask(smi_line):
    """The multitask MCD iteration of the train cell's model with a depth
    and a boundary head (weights 0.5 and 1.0): timed like phase ``train``,
    2 launches per iteration, finite losses, every tensor of G, F1, F2, D
    and B moved; a float64 card-vs-CPU step on inputs preprocessed once on
    the CPU; then ``train_multitask``, ``evaluate`` and depth serving."""
    import math

    import torch

    from mcseg_tpu_torch.models.factory import init_aux_heads, init_models
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.loops import make_multitask_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    cfg = _train_config("bfloat16")
    state = create_train_state(cfg.model, cfg.train, 0, DEVICE, aux_heads=("D", "B"))
    src, tgt = _raw_pair(cfg, B, DEVICE)  # staged on the card before timing
    iterate = make_multitask_iteration(cfg, MT_DEPTH_WEIGHT, MT_BOUNDARY_WEIGHT)
    before = _snapshot(state)
    for _ in range(TRAIN_WARMUP):
        iterate(state, src, tgt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_normalize_stack.launches = 0  # count only the main path from here
    times, metrics = [], []
    for i in range(TRAIN_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = iterate(state, src, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if fused_normalize_stack.launches != 2 * (i + 1):
            raise AssertionError(f"multitask iteration {i}: normalize kernel launched "
                                 f"{fused_normalize_stack.launches} times in total")
    launches = fused_normalize_stack.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"multitask: non-finite metrics {metrics}")
    unchanged = _unchanged(before, _snapshot(state))
    if unchanged or sorted(before) != ["B", "D", "F1", "F2", "G"]:
        raise AssertionError(f"multitask: not updated by training: {unchanged[:10]}")
    ms = statistics.median(times)
    breakdown = _train_breakdown(iterate, state, src, tgt)
    del state, before
    torch.cuda.empty_cache()

    small = _train_config("float32", hw=(48, 64), batch=2)
    gen = torch.Generator().manual_seed(0)
    params = init_models(small.model, gen)
    params.update(init_aux_heads(small.model, ("D", "B"), gen))
    card_vs_cpu, failures = _family_card_vs_cpu({}, params)
    loop = _multitask_loop(smi_line)
    emit("multitask", phase_seconds=time.perf_counter() - t_phase, net=cfg.model.net, input_ch=6, n_class=40, batch=B, hw=[H, W],
         dtype="bfloat16", num_k=cfg.train.num_k, upsample="convt",
         depth_weight=MT_DEPTH_WEIGHT, boundary_weight=MT_BOUNDARY_WEIGHT,
         warmup=TRAIN_WARMUP, iterations=TRAIN_TIMED, launches=launches,
         launches_per_iteration=launches / TRAIN_TIMED,
         ms_per_iteration=ms, ms_per_iteration_all=times,
         images_per_s=2 * B / ms * 1e3, peak_mem_gb=peak_gb, metrics=metrics,
         breakdown_ms=breakdown, card_vs_cpu=card_vs_cpu, bounds=CARD_VS_CPU_BOUNDS,
         loop=loop, card=smi_line,
         note="device rate: raw batches staged on the card; images counted as "
              "source plus target (2 x batch) per iteration; random weights")
    if failures:
        raise AssertionError(f"multitask card vs CPU float64 step: {failures}")
    return launches


def _cli_argv(out_dir, input_ch=6):
    """The reference command line of the ``cli`` phase at full width."""
    return ["--net", "drn_d_38", "--input_ch", str(input_ch), "--train_img_shape", str(W), str(H),
            "--batch_size", str(B), "--dtype", "bfloat16", "--max_samples", str(2 * B),
            "--epochs", "1", "--log_every", "1", "--out_dir", out_dir]


def _logged(out_dir, keys):
    """The run's JSONL log records; raises unless every ``keys`` value of
    every training record is finite."""
    import math

    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        logged = [json.loads(ln) for ln in f]
    bad = [r for r in logged if not all(math.isfinite(r[k]) for k in keys)]
    if not logged or bad:
        raise AssertionError(f"{out_dir}: non-finite or missing losses: {bad or logged}")
    return logged


def phase_cli(smi_line):
    """The reference commands in process through their ``main`` on the
    card, at full width, each with the launch count reset just before it
    and read just after: the four of MCD and source-only training and
    testing, then ``multitask_train --input_ch 3 --source_only`` and
    ``adapt_test`` of its checkpoint, whose table must carry the depth
    line; a ``--resume`` whose ``--upsample`` differs from the
    checkpoint's must raise, and ``python -m ...adapt_test`` must exit 0
    and print the IoU table."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from mcseg_tpu_torch.cli import (
        adapt_test, adapt_train, multitask_train, source_test, source_train)
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    report = {}

    def run(name, fn, want_launches):
        fused_normalize_stack.launches = 0
        t0 = time.perf_counter()
        out = fn()
        report[name] = {"seconds": time.perf_counter() - t0,
                        "launches": fused_normalize_stack.launches}
        if fused_normalize_stack.launches != want_launches:
            raise AssertionError(f"{name}: normalize kernel launched "
                                 f"{fused_normalize_stack.launches} times, not {want_launches}")
        return out

    eval_batches = 2  # the sidecar's max_samples (16) of val over batch 8
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="cli_") as tmp:
        adapt_dir, src_dir = os.path.join(tmp, "adapt"), os.path.join(tmp, "source")
        state = run("adapt_train", lambda: adapt_train.main(
            ["synthetic", "synthetic_shifted", "--num_k", "4"] + _cli_argv(adapt_dir),
            device=DEVICE), 4)
        logged = _logged(adapt_dir, ("loss_source", "loss_b", "loss_dis"))
        if state.step != 2 or len(logged) != 2:
            raise AssertionError(f"adapt_train: {state.step} iterations, {len(logged)} logged")
        miou = run("adapt_test", lambda: adapt_test.main(
            [os.path.join(adapt_dir, "last")], device=DEVICE), eval_batches)
        report["adapt_test"]["miou"] = miou
        state = run("source_train", lambda: source_train.main(
            ["synthetic"] + _cli_argv(src_dir), device=DEVICE), 2)
        logged = _logged(src_dir, ("loss",))
        if state.step != 2 or len(logged) != 2:
            raise AssertionError(f"source_train: {state.step} steps, {len(logged)} logged")
        miou_f1 = run("source_test", lambda: source_test.main(
            [os.path.join(src_dir, "last")], device=DEVICE), eval_batches)
        report["source_test"]["miou"] = miou_f1
        if not (np.isfinite(miou) and np.isfinite(miou_f1)):
            raise AssertionError(f"mIoU adapt {miou}, source {miou_f1}")
        # the multitask command with the stack of the JAX package's documented
        # multitask run (RGB only), source-only, then the test command on it
        mt_dir = os.path.join(tmp, "multitask")
        state = run("multitask_train", lambda: multitask_train.main(
            ["synthetic", "synthetic_shifted", "--source_only", "--depth_weight",
             str(MT_DEPTH_WEIGHT)] + _cli_argv(mt_dir, input_ch=3), device=DEVICE), 2)
        logged = _logged(mt_dir, ("loss", "loss_seg", "loss_depth"))
        if state.step != 2 or len(logged) != 2 or state.d is None:
            raise AssertionError(f"multitask_train: {state.step} steps, {len(logged)} logged")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            miou_mt = run("multitask_adapt_test", lambda: adapt_test.main(
                [os.path.join(mt_dir, "last")], device=DEVICE), eval_batches)
        depth_line = [ln for ln in out.getvalue().splitlines() if ln.startswith("depth:")]
        if not np.isfinite(miou_mt) or len(depth_line) != 1:
            raise AssertionError(f"adapt_test of the multitask checkpoint: mIoU {miou_mt}\n"
                                 f"{out.getvalue()[-1000:]}")
        report["multitask_adapt_test"].update(miou=miou_mt, depth_line=depth_line[0])
        # a structural drift on resume is refused before any state is built
        try:
            run("resume_upsample_drift", lambda: adapt_train.main(
                ["synthetic", "synthetic_shifted", "--upsample", "resize", "--resume",
                 os.path.join(adapt_dir, "last")] + _cli_argv(os.path.join(tmp, "drift")),
                device=DEVICE), 0)
        except ValueError as e:
            if "--upsample: checkpoint has 'convt', CLI has 'resize'" not in str(e):
                raise
            report["resume_upsample_drift"] = {"raised": str(e).splitlines()[1].strip()}
        else:
            raise AssertionError("--resume with another --upsample did not raise")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mcseg_tpu_torch.cli.adapt_test",
             os.path.join(adapt_dir, "last"), "--max_samples", str(B)],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        report["python_m_adapt_test"] = {"seconds": time.perf_counter() - t0,
                                         "returncode": proc.returncode,
                                         "stdout_tail": proc.stdout[-300:]}
        if proc.returncode != 0 or "per-class IoU" not in proc.stdout \
                or "mIoU:" not in proc.stdout:
            raise AssertionError(f"python -m adapt_test: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    emit("cli", net="drn_d_38", input_ch=6, batch=B, hw=[H, W], dtype="bfloat16",
         commands=report, card=smi_line,
         note="in-process main(argv, device='cuda'); seconds include the host "
              "decode of the synthetic corpora and the checkpoint writes")
    return sum(r.get("launches", 0) for r in report.values())


FAMILIES = (  # one MCD configuration per --net, --fusion or --input_ch the slices add
    {"net": "drn_d_54"}, {"net": "drn_d_105"}, {"net": "drn_c_26"}, {"net": "drn_c_42"},
    {"net": "drn_d_38", "fusion": "late"}, {"net": "drn_d_38", "input_ch": 4},
    {"net": "drn_d_38", "input_ch": 1}, {"net": "fcn8s_vgg16"}, {"net": "psp"},
)
FAMILIES_CARD_VS_CPU = ({"net": "drn_d_54"}, {"net": "drn_c_26"},
                        {"net": "drn_d_38", "fusion": "late"}, {"net": "fcn8s_vgg16"},
                        {"net": "psp"})
# one evaluate batch and a stage breakdown each
FAMILIES_IN_DEPTH = ({"net": "fcn8s_vgg16"}, {"net": "psp"})
FAMILY_TIMED = 2  # iterations after one warm-up, which also counts the FLOPs


def _family_run(family, smi_line):
    import math

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    cfg = _train_config("bfloat16", **family)
    state = create_train_state(cfg.model, cfg.train, 0, DEVICE)
    src, tgt = _raw_pair(cfg, B, DEVICE)
    iterate = make_adapt_iteration(cfg)
    before = _snapshot(state)
    with FlopCounterMode(display=False) as counter:
        iterate(state, src, tgt)
    iteration_tflop = counter.get_total_flops() / 1e12
    # FlopCounterMode attributes backward ops to modules by hooks that
    # interleave across two trunks, so a trunk's own count is read only
    # where G is one trunk
    counts, trunk = counter.get_flop_counts(), type(state.g).__name__
    trunk_tflop = (sum(counts[trunk].values()) / 1e12
                   if trunk in counts and cfg.model.fusion != "late" else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_normalize_stack.launches = 0  # count only the timed iterations
    times, metrics = [], []
    for i in range(FAMILY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = iterate(state, src, tgt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        if fused_normalize_stack.launches != 2 * (i + 1):
            raise AssertionError(f"{family} iteration {i}: normalize kernel launched "
                                 f"{fused_normalize_stack.launches} times in total")
    launches = fused_normalize_stack.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError(f"{family}: non-finite metrics {metrics}")
    unchanged = _unchanged(before, _snapshot(state))
    if unchanged:
        raise AssertionError(f"{family}: not updated by training: {unchanged[:10]}")
    ms = statistics.median(times)
    n_params = sum(p.numel() for m in (state.g, state.f1, state.f2) for p in m.parameters())
    detail = {}
    if family in FAMILIES_IN_DEPTH:
        detail["breakdown_ms"] = _train_breakdown(iterate, state, src, tgt)
        detail["evaluate"] = _family_evaluate(cfg, state)
        if family["net"] == "fcn8s_vgg16":  # its head upsamples in float32, as JAX's
            detail["convt_8x_one_head_fwd_bwd_ms"] = {
                "float32": _convt_8x_ms(torch.float32), "bfloat16": _convt_8x_ms(torch.bfloat16)}
    del state, before
    torch.cuda.empty_cache()
    return {"family": {"net": cfg.model.net, "input_ch": cfg.model.input_ch,
                       "fusion": cfg.model.fusion},
            "params_m": n_params / 1e6, "launches": launches,
            "launches_per_iteration": launches / FAMILY_TIMED,
            "ms_per_iteration": ms, "ms_per_iteration_all": times,
            "images_per_s": 2 * B / ms * 1e3, "peak_mem_gb": peak_gb,
            "iteration_tflop": iteration_tflop,
            "iteration_share_of_bf16_peak": iteration_tflop / ms * 1e3 / H100_BF16_FLOPS * 1e12,
            "trunk_tflop_per_iteration": trunk_tflop, "metrics": metrics, **detail}


def _convt_8x_ms(dtype):
    """Forward plus backward of one head's 8x ``convt`` upsample, [B, 40,
    H/8, W/8] -> [B, 40, H, W] in ``dtype``, by CUDA events."""
    import torch

    from mcseg_tpu_torch.ops.upsample import upsample_bilinear_convt

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    score = torch.randn((B, 40, H // 8, W // 8), generator=gen, device=DEVICE,
                        dtype=dtype).requires_grad_(True)
    cot = torch.randn((B, 40, H, W), generator=gen, device=DEVICE, dtype=dtype)

    def fwd_bwd():
        up = upsample_bilinear_convt(score, 8)
        up.backward(cot)
        return up

    return gpu_time_ms(fwd_bwd, runs=5, per_run=2)


def _family_evaluate(cfg, state):
    """``evaluate`` of one val batch from the trained ``state`` (G in eval
    mode, F1 and F2 averaged), with the launch count reset just before it
    and read just after: one launch, a finite mIoU."""
    import numpy as np

    from mcseg_tpu_torch.eval.tester import evaluate
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack

    fused_normalize_stack.launches = 0
    t0 = time.perf_counter()
    miou, hist, _ = evaluate(state.params(), cfg, max_batches=1, print_table=False,
                             device=DEVICE)
    secs = time.perf_counter() - t0
    if fused_normalize_stack.launches != 1 or not np.isfinite(miou) or hist.sum() == 0:
        raise AssertionError(f"{cfg.model.net}: evaluate of the trained state: mIoU {miou}, "
                             f"{fused_normalize_stack.launches} launches")
    return {"miou": miou, "launches": 1, "seconds": secs, "hist_pixels": int(hist.sum())}


def _family_step(dtype, device, params, inputs, cfg, masks=None):
    """One MCD step (A / B / C x num_k) of ``cfg``'s model from ``params``
    on ``inputs`` (preprocessed xs, ys, xt on the CPU; xs, ys, ds, xt for
    the multitask step, whose ``params`` hold the auxiliary heads), on
    ``device`` in ``dtype``, G's dropout fed ``masks`` in call order when
    given: (metrics, weights before, weights after), the weights on the
    CPU."""
    import torch

    from mcseg_tpu_torch.core.device import compute_dtype
    from mcseg_tpu_torch.models.fcn_vgg import GivenMasks
    from mcseg_tpu_torch.train.mcd import make_mcd_step
    from mcseg_tpu_torch.train.multitask import make_multitask_mcd_step
    from mcseg_tpu_torch.train.state import create_train_state

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    dt = compute_dtype(dtype)
    aux = [k for k in ("D", "B") if k in params]
    state = create_train_state(cfg.model, cfg.train, 0, device, params=params, aux_heads=aux)
    if masks is not None:
        state.install_masks(GivenMasks(masks))
    before = _snapshot(state)
    xs, ys, xt = inputs[0].to(device, dt), inputs[1].to(device), inputs[-1].to(device, dt)
    if aux:
        step = make_multitask_mcd_step(cfg.train, MT_DEPTH_WEIGHT, MT_BOUNDARY_WEIGHT, dt)
        ds = inputs[2].to(device, torch.promote_types(dt, torch.float32))
        metrics = step(state, xs, ys, ds, xt)
    else:
        metrics = make_mcd_step(cfg.train, False, dt)(state, xs, ys, xt)

    def cpu(snap):
        return {n: {k: v.cpu().double() for k, v in sd.items() if v.is_floating_point()}
                for n, sd in snap.items()}

    return {k: float(v) for k, v in metrics.items()}, cpu(before), cpu(_snapshot(state))


def _cpu_inputs(cfg, with_depth=False):
    """The first train batch of source and target at ``cfg``'s shape,
    preprocessed once on the CPU with iteration 0's draws: (xs, ys, xt)
    NCHW, or (xs, ys, ds, xt) ``with_depth``."""
    import torch

    from mcseg_tpu_torch.ops.preprocess import (
        draw_augment, make_train_preprocess, pre_crop_canvas)
    from mcseg_tpu_torch.train.loops import augment_generator

    pre, target = pre_crop_canvas(cfg.data)
    gen = augment_generator(cfg.train.seed, 0)
    src, tgt = _raw_pair(cfg, 2, "cpu")
    b = src["image"].shape[0]
    xs, ys, *ds = make_train_preprocess(cfg.data, torch.float32, with_depth=with_depth)(
        src, *draw_augment(gen, b, pre, target, cfg.data))
    xt, _ = make_train_preprocess(cfg.data, torch.float32)(
        {k: v for k, v in tgt.items() if k != "label"}, *draw_augment(gen, b, pre, target, cfg.data))
    return (xs.permute(0, 3, 1, 2), ys, *ds, xt.permute(0, 3, 1, 2))


def _dropout_masks(cfg, b, hw):
    """Keep-masks for every dropout of one MCD step of ``cfg``'s model at
    batch ``b`` and ``hw``, drawn on the CPU from a seeded generator, or
    None for a trunk without dropout: A, B source, B target and C x num_k
    each draw one mask per ``Dropout`` (VGG's drop6 and drop7, on the /32
    map rounded up)."""
    import torch

    from mcseg_tpu_torch.models.factory import FCN_NETS

    if cfg.model.net not in FCN_NETS:
        return None
    gen = torch.Generator().manual_seed(2)
    shape = (b, 4096, -(-hw[0] // 32), -(-hw[1] // 32))
    return [torch.rand(shape, generator=gen) < 0.5 for _ in range(2 * (3 + cfg.train.num_k))]


def _family_card_vs_cpu(family, params=None):
    """One MCD step at batch 2, 48x64 on the card and on the CPU from the
    same weights, the same preprocessed inputs (made once on the CPU) and,
    for a trunk with dropout, the same masks (drawn once on the CPU),
    in float64, held to CARD_VS_CPU_BOUNDS, and in float32, reported
    beside the CPU's own float32 error from float64 and beside a float64
    CPU step whose inputs are perturbed by 1e-7 relative noise. The step
    is too ill-conditioned at this shape to take the preprocess of each
    device or float32 rounding: on the CPU, in float64, that perturbation
    moves drn_d_54's update by ~6% (4e-2 bound), and its float32 update
    differs from float64 by as much; the card's kernel and HHA differ from
    the CPU's by more than 1e-7. Float64 on the same inputs shows that the
    card computes the same step; float32 shows how far rounding goes.
    ``params`` with auxiliary heads runs the multitask step."""
    import torch

    from mcseg_tpu_torch.models.factory import init_models

    cfg = _train_config("float32", hw=(48, 64), batch=2, **family)
    if params is None:
        params = init_models(cfg.model, torch.Generator().manual_seed(0))
    inputs = _cpu_inputs(cfg, with_depth="D" in params)
    masks = _dropout_masks(cfg, 2, (48, 64))
    card64 = _family_step("float64", DEVICE, params, inputs, cfg, masks)
    cpu64 = _family_step("float64", "cpu", params, inputs, cfg, masks)
    card32 = _family_step("float32", DEVICE, params, inputs, cfg, masks)
    cpu32 = _family_step("float32", "cpu", params, inputs, cfg, masks)
    noise = torch.Generator().manual_seed(1)
    perturbed = tuple(x * (1 + 1e-7 * torch.randn(x.shape, generator=noise, dtype=x.dtype))
                      if x.is_floating_point() else x for x in inputs)
    cpu64_perturbed = _family_step("float64", "cpu", params, perturbed, cfg, masks)
    report = {"family": family,
              "card_fp64_vs_cpu_fp64": _iteration_errors(card64, cpu64),
              "cpu_fp64_input_noise_1e-7_vs_cpu_fp64": _iteration_errors(cpu64_perturbed, cpu64),
              "card_fp32_vs_cpu_fp32": _iteration_errors(card32, cpu32),
              "card_fp32_vs_cpu_fp64": _iteration_errors(card32, cpu64),
              "cpu_fp32_vs_cpu_fp64": _iteration_errors(cpu32, cpu64)}
    failures = [f"{family}: {k} {report['card_fp64_vs_cpu_fp64'][k]:.3g} > {b}"
                for k, b in CARD_VS_CPU_BOUNDS.items()
                if not report["card_fp64_vs_cpu_fp64"][k] <= b]
    return report, failures


def _fresh_masks_check():
    """On the card, ``fcn8s_vgg16`` with num_k 2 and the train state's own
    mask source (``SeededMasks``): one MCD iteration at batch 2, 48x64
    draws 10 masks, and step C's two repetitions draw different ones."""
    import torch

    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state

    cfg = _train_config("bfloat16", hw=(48, 64), batch=2, net="fcn8s_vgg16")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_k=2))
    state = create_train_state(cfg.model, cfg.train, 0, DEVICE)
    source, drawn = state.masks, []

    def recording(shape, device):
        drawn.append(source(shape, device))
        return drawn[-1]

    recording.reseed = source.reseed
    state.install_masks(recording)
    src, tgt = _raw_pair(cfg, 2, DEVICE)
    make_adapt_iteration(cfg)(state, src, tgt)
    torch.cuda.synchronize()
    c = drawn[6:]  # C repetition 0: drop6, drop7; repetition 1: drop6, drop7
    fresh = len(drawn) == 10 and all(m.device.type == DEVICE for m in drawn) and not any(
        torch.equal(a, b) for a, b in ((c[0], c[2]), (c[1], c[3])))
    report = {"masks": len(drawn), "device": str(drawn[0].device),
              "keep_share": float(torch.stack(drawn).float().mean()),
              "step_c_repetitions_differ": fresh}
    del state
    torch.cuda.empty_cache()
    if not fresh:
        raise AssertionError(f"step C's dropout masks: {report}")
    return report


def phase_families(smi_line):
    """One MCD configuration of each family the CLI flags reach beyond the
    main one, at full width (640x480, batch 8, bf16, num_k 4): 2 launches
    per iteration, finite losses, every tensor moved, a stage breakdown and
    one ``evaluate`` batch of the FCN8s and PSP states; a card-vs-CPU
    iteration at 48x64 for five of them (``_family_card_vs_cpu``); and step
    C's fresh dropout masks on the card (``_fresh_masks_check``)."""
    runs = [_family_run(f, smi_line) for f in FAMILIES]
    checks, failures = [], []
    for family in FAMILIES_CARD_VS_CPU:
        report, fails = _family_card_vs_cpu(family)
        checks.append(report)
        failures += fails
    emit("families", batch=B, hw=[H, W], dtype="bfloat16", num_k=4, upsample="convt",
         warmup=1, iterations=FAMILY_TIMED, runs=runs, card_vs_cpu=checks,
         bounds=CARD_VS_CPU_BOUNDS, fresh_dropout_masks=_fresh_masks_check(), card=smi_line,
         note="raw batches staged on the card; images counted as source plus "
              "target (2 x batch) per iteration; random weights")
    if failures:
        raise AssertionError(f"card vs CPU float64 iteration: {failures}")
    return sum(r["launches"] + r.get("evaluate", {}).get("launches", 0) for r in runs)


CORPUS_N = 32  # samples of each on-disk corpus: 4 iterations of batch 8 per epoch
CITY_N, CITY_HW = 8, (1024, 2048)  # Cityscapes files (H, W) as the corpus ships them
CITY_LABEL_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 26)  # raw class -> labelId


def _png(arr):
    """PNG bytes of uint8 [H,W] (gray) or [H,W,3] (RGB), or uint16 [H,W]
    (16-bit gray, big-endian): the standard library's zlib, filter byte 0."""
    import struct
    import zlib

    import numpy as np

    arr = np.ascontiguousarray(arr)
    depth, color = (16, 0) if arr.dtype == np.uint16 else (8, 2 if arr.ndim == 3 else 0)
    rows = (arr.astype(">u2").view(np.uint8) if depth == 16 else arr).reshape(arr.shape[0], -1)
    raw = np.concatenate([np.zeros((arr.shape[0], 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def _png_size(path):
    """(H, W) from a PNG's IHDR."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def _edges(label):
    """uint8 {0, 255} map of the pixels with a 4-neighbour of another valid
    class (raw 0 = void), the rule of ``losses/seg.py``'s boundary targets."""
    import numpy as np

    valid = label != 0
    edge = np.zeros(label.shape, bool)
    ev = (label[1:] != label[:-1]) & valid[1:] & valid[:-1]
    eh = (label[:, 1:] != label[:, :-1]) & valid[:, 1:] & valid[:, :-1]
    edge[1:] |= ev
    edge[:-1] |= ev
    edge[:, 1:] |= eh
    edge[:, :-1] |= eh
    return edge.astype(np.uint8) * 255


def _write_corpora(root):
    """A SUNCG-layout source (``synthetic``) and an NYU-layout target
    (``synthetic_shifted``) of CORPUS_N samples at H x W (RGB, raw label,
    16-bit depth in mm, boundary PNGs), and a Cityscapes val layout of
    CITY_N frames at CITY_HW, all from the port's procedural generator."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import get_dataset

    def write(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(_png(arr))

    def nyu_sample(name, corpus, i):
        s = corpus[i]
        stem = f"{i:05d}.png"
        write(os.path.join(root, name, "train_rgb", stem), s["image"])
        write(os.path.join(root, name, "train_label", stem), s["label"])
        write(os.path.join(root, name, "train_depth", stem),
              np.round(s["depth"] * 1000.0).astype(np.uint16))
        write(os.path.join(root, name, "train_boundary", stem), _edges(s["label"]))

    city = get_dataset("synthetic", DataConfig(train_img_shape=CITY_HW[::-1]), "train")
    ids = np.zeros(256, np.uint8)
    ids[: len(CITY_LABEL_IDS)] = CITY_LABEL_IDS

    def city_frame(i):
        s = city[100 + i]
        stem = f"cityA_{i:06d}_000019"
        write(os.path.join(root, "city", "leftImg8bit", "val", "cityA", stem + "_leftImg8bit.png"),
              s["image"])
        write(os.path.join(root, "city", "gtFine", "val", "cityA", stem + "_gtFine_labelIds.png"),
              ids[s["label"]])

    cfg = DataConfig(train_img_shape=(W, H), max_samples=CORPUS_N)
    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        jobs = [ex.submit(nyu_sample, name, get_dataset(src, cfg, "train"), i)
                for name, src in (("suncg", "synthetic"), ("nyu", "synthetic_shifted"))
                for i in range(CORPUS_N)]
        jobs += [ex.submit(city_frame, i) for i in range(CITY_N)]
        for j in jobs:
            j.result()


def _decode_rate(dataset, batch, num_workers, epochs=1):
    """Host images per second of ``batch_iterator`` over ``dataset`` (both
    sides of a pair counted), and the decode routes it used."""
    from mcseg_tpu_torch import native
    from mcseg_tpu_torch.data.pipeline import batch_iterator

    before = dict(native.routes)
    t0 = time.perf_counter()
    n = 0
    for item in batch_iterator(dataset, batch, seed=0, epochs=epochs, num_workers=num_workers):
        n += sum(b["image"].shape[0] for b in (item if isinstance(item, tuple) else (item,)))
    secs = time.perf_counter() - t0
    routes = {k: native.routes[k] - before[k] for k in native.routes if native.routes[k] > before[k]}
    if len(routes) != 1:
        raise AssertionError(f"one reading mixed decode routes: {routes}")
    return {"num_workers": num_workers, "images": n, "seconds": secs, "images_per_s": n / secs,
            "route": next(iter(routes)), "files_decoded": sum(routes.values())}


def _corpus_config(root, out_dir, input_ch=6, **kw):
    """BASELINE config 4's training (``suncg nyu --input_ch 6``, DRN-D-38,
    40 classes, bf16, batch 8, num_k 4) on the files under ``root``."""
    data_kw = {k: kw.pop(k) for k in list(kw) if k in (
        "device_corpus", "num_workers", "decode_cache_gb", "decode_disk_cache_gb")}
    cfg = _train_config("bfloat16", input_ch=input_ch, out_dir=out_dir, log_every=1, **kw)
    return dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, src_dataset="suncg", tgt_dataset="nyu", data_root=root, **data_kw))


def _file_fed_run(cfg, timed_from, snapshot_epoch=None, **run_kw):
    """``train_adapt`` of ``cfg`` with its input stream observed: the seconds
    the loop waited on each batch, and, from iteration ``timed_from`` on,
    the wall time (synchronized at both ends) and the card's busy time
    under ``torch.profiler``; both readers' ``io_stats`` at the end of the
    run, and at the end of epoch ``snapshot_epoch`` a host copy of G, F1
    and F2."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train import loops
    from mcseg_tpu_torch.utils.logging import JsonlLogger

    rec = {"waits": [], "yields": []}
    real = loops._input_stream

    def observed(dataset, dev, cfg_, start_epoch):
        rec["dataset"] = dataset
        inner = real(dataset, dev, cfg_, start_epoch)
        prof = None
        try:
            for i in range(10**9):
                if i == timed_from:
                    torch.cuda.synchronize()
                    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                    prof.start()
                    rec["t0"] = time.perf_counter()
                t = time.perf_counter()
                try:
                    item = next(inner)
                except StopIteration:
                    break
                rec["waits"].append(time.perf_counter() - t)
                rec["yields"].append(time.perf_counter())
                yield item
        finally:
            if prof is not None:
                torch.cuda.synchronize()
                rec["t1"] = time.perf_counter()
                prof.stop()
                rec["prof"] = prof
            inner.close()

    def on_epoch_end(epoch, state):
        if epoch == snapshot_epoch:
            rec["snapshot"] = {n: {k: v.detach().to("cpu", copy=True)
                                   for k, v in m.state_dict().items()}
                               for n, m in state.modules().items()}

    logger = JsonlLogger(os.path.join(cfg.train.out_dir, "train_log.jsonl"), echo=False)
    loops._input_stream = observed
    fused_normalize_stack.launches = 0
    t_run = time.perf_counter()
    try:
        state = loops.train_adapt(cfg, logger=logger, on_epoch_end=on_epoch_end, device=DEVICE,
                                  **run_kw)
    finally:
        loops._input_stream = real
        logger.close()
    run_s = time.perf_counter() - t_run
    launches = fused_normalize_stack.launches
    steps = state.step
    del state
    gc.collect()
    torch.cuda.empty_cache()
    logged = _logged(cfg.train.out_dir, ("loss_source", "loss_b", "loss_dis"))
    if launches != 2 * steps or len(logged) != steps:
        raise AssertionError(f"{cfg.train.out_dir}: {launches} kernel launches, "
                             f"{len(logged)} logged, in {steps} iterations")
    z = rec["dataset"]
    out = {"iterations": steps, "launches": launches, "run_seconds": run_s,
           "first_batch_wait_s": rec["waits"][0],
           "io_stats": {"source": dict(z.source.io_stats), "target": dict(z.target.io_stats)},
           "losses": [{k: r[k] for k in ("loss_source", "loss_b", "loss_dis")} for r in logged]}
    if "prof" in rec:
        t_summary = time.perf_counter()
        n_timed = steps - timed_from
        # the raw device events (kernels, copies, sets): key_averages() would
        # first build the tree of every CPU op, tens of seconds per run
        events = [e for e in rec["prof"].profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.duration_ns() for e in events) / 1e6
        copy_ms = sum(e.duration_ns() for e in events if "memcpy" in e.name().lower()) / 1e6
        if DEVICE == "cuda" and busy_ms <= 0:
            raise AssertionError("the profiler recorded no device time")
        wall_ms = (rec["t1"] - rec["t0"]) * 1e3
        gaps = [(b - a) * 1e3 for a, b in zip(rec["yields"][timed_from:], rec["yields"][timed_from + 1:])]
        out.update(timed_iterations=n_timed, ms_per_iteration=wall_ms / n_timed,
                   ms_between_batches_median=statistics.median(gaps) if gaps else None,
                   ms_between_batches=gaps, device_busy_ms=busy_ms, device_copy_ms=copy_ms,
                   device_idle_share=1.0 - busy_ms / wall_ms,
                   stream_wait_s_timed=sum(rec["waits"][timed_from:]),
                   stream_wait_s_all=sum(rec["waits"]),
                   profile_summary_s=time.perf_counter() - t_summary)
    return out, rec.get("snapshot")


def _stream_checks(root):
    """On the card: the first 3 batch pairs of the card-resident gather, and
    every pair of the prefetching stream, equal the host path's pairs after
    ``wire_format``, copied synchronously."""
    import torch

    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
    from mcseg_tpu_torch.data.device_corpus import corpus_stream
    from mcseg_tpu_torch.data.pipeline import batch_iterator, device_prefetch, wire_items

    cfg = DataConfig(data_root=root, batch_size=B, decode_cache_gb=1.0)
    z = ZipDataset(get_dataset("suncg", cfg, "train"), get_dataset("nyu", cfg, "train"))
    host = [tuple({k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()} for b in wire_items(item))
            for item in batch_iterator(z, B, seed=0, epochs=1)]

    def same(stream, n):
        got = 0
        for g, w in zip(stream, host[:n]):
            for gb, wb in zip(g, w):
                if gb.keys() != wb.keys() or not all(torch.equal(gb[k], wb[k]) for k in wb):
                    raise AssertionError(f"batch {got} differs from the host path's")
            got += 1
        if got != n:
            raise AssertionError(f"{got} batches, not {n}")
        return n

    gathered = corpus_stream(z, DEVICE, B, seed=0, epochs=1)
    prefetched = device_prefetch(batch_iterator(z, B, seed=0, epochs=1, num_workers=4), DEVICE)
    try:
        return {"device_corpus_pairs_equal": same(gathered, min(3, len(host))),
                "prefetch_pairs_equal": same(prefetched, len(host)),
                "planes": {"source": sorted(host[0][0]), "target": sorted(host[0][1])}}
    finally:
        gathered.close()
        prefetched.close()


def _submit_check(root, tmp):
    """``adapt_test --submit_dir`` of a random-weight Cityscapes checkpoint
    (DRN-D-38, RGB, 19 classes) on 2 val frames: 2 labelId dumps at
    2048x1024, named after their frames, from one kernel launch."""
    import torch

    from mcseg_tpu_torch.cli import adapt_test
    from mcseg_tpu_torch.core.config import (
        DataConfig, ExperimentConfig, ModelConfig, TrainConfig)
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = ExperimentConfig(
        model=ModelConfig(net="drn_d_38", input_ch=3, n_class=19, dtype="bfloat16"),
        data=DataConfig(src_dataset="city", tgt_dataset="city", batch_size=2,
                        test_img_shape=(1024, 512), input_ch=3, data_root=root),
        train=TrainConfig(seed=0))
    state = create_train_state(cfg.model, cfg.train, 0, DEVICE)
    prefix = os.path.join(tmp, "city_ckpt")
    save_checkpoint(prefix, state, cfg)
    del state
    submit = os.path.join(tmp, "submit")
    fused_normalize_stack.launches = 0
    t0 = time.perf_counter()
    miou = adapt_test.main([prefix, "--split", "val", "--max_samples", "2",
                            "--submit_dir", submit], device=DEVICE)
    secs = time.perf_counter() - t0
    launches = fused_normalize_stack.launches
    names = sorted(os.listdir(submit))
    want = [f"cityA_{i:06d}_000019_leftImg8bit.png" for i in range(2)]
    sizes = [_png_size(os.path.join(submit, n)) for n in names]
    if names != want or sizes != [(1024, 2048)] * 2 or launches != 1:
        raise AssertionError(f"--submit_dir: {names} {sizes}, {launches} launches")
    torch.cuda.empty_cache()
    return {"dumps": names, "hw": sizes[0], "launches": launches, "seconds": secs,
            "miou": miou}


def phase_corpus(smi_line, staged_ms=None):
    """The host side of a real run on the card: on-disk corpora written by
    the script, the decoder route, host decode rates against the device's,
    ``train_adapt`` fed from files (decode threads, prefetch, RAM cache, an
    async ``ep1``), then one epoch each on the card-resident corpus and
    through the disk cache (filling, then reading), the stream checks, one
    ``--input_ch 7`` iteration from the boundary files and a
    ``--submit_dir`` run. Every file it writes is under build/corpus_* and
    removed at the end."""
    import tempfile

    import torch

    from mcseg_tpu_torch import native
    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset

    t_phase = time.perf_counter()
    native_ok = native.available()
    env = {"decoder": "native" if native_ok else "pil", "native_build": native.build_report(),
           "nproc": os.cpu_count(), "native_threads_per_call": native.auto_threads()}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    report = {}
    laps, last = {}, [time.perf_counter()]

    def lap(name):  # seconds of each step of the phase
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="corpus_") as tmp:
        root = os.path.join(tmp, "data")
        _write_corpora(root)
        lap("write_corpora")
        cold = DataConfig(data_root=root, decode_cache_gb=0.0)
        z = ZipDataset(get_dataset("suncg", cold, "train"), get_dataset("nyu", cold, "train"))
        city = get_dataset("city", cold, "val")
        report["decode"] = {
            "suncg_nyu_640x480_batch8": [_decode_rate(z, B, w) for w in (1, 4)],
            "city_val_2048x1024_to_1024x512_batch2": [_decode_rate(city, 2, w) for w in (1, 4)],
            "note": "RAM cache off; a pair counts its source and target images; "
                    "per sample RGB, label, 16-bit depth and boundary PNGs (city: RGB "
                    "decoded to 1024x512, labels at 2048x1024)"}
        device_rate = 2 * B / staged_ms * 1e3 if staged_ms else None
        report["device_images_per_s_staged"] = device_rate
        for r in report["decode"]["suncg_nyu_640x480_batch8"]:
            r["host_over_device"] = r["images_per_s"] / device_rate if device_rate else None
        lap("decode_rates")

        run = os.path.join(tmp, "run")
        cfg = _corpus_config(root, run, epochs=2, device_corpus="off", num_workers=4)
        files, snap = _file_fed_run(cfg, timed_from=2, snapshot_epoch=1)
        ep1 = torch.load(os.path.join(run, "ep1.pt"), map_location="cpu", weights_only=True)
        diff = [f"{n}.{k}" for n, sd in snap.items() for k, v in sd.items()
                if not torch.equal(ep1[n][k], v)]
        if diff:
            raise AssertionError(f"async ep1 differs from the state at epoch 1: {diff[:5]}")
        files["async_ep1_equals_epoch1_state"] = True
        files["staged_ms_per_iteration"] = staged_ms
        # epoch 1 meets an empty RAM cache and loads each sample once: all
        # CORPUS_N loads decode, so epoch 2 is the run's total less those
        files["io_stats_epoch2"] = {}
        for side, st in files["io_stats"].items():
            if st["decodes"] + st["ram_hits"] != 2 * CORPUS_N or st["decodes"] < CORPUS_N:
                raise AssertionError(f"{side} io_stats of 2 epochs: {st}")
            files["io_stats_epoch2"][side] = {**st, "decodes": st["decodes"] - CORPUS_N}
        report["files"] = files
        lap("files")
        on_card, _ = _file_fed_run(_corpus_config(root, os.path.join(tmp, "on"), epochs=1,
                                                  device_corpus="on", checkpoint_every_epochs=0),
                                   timed_from=1)
        on_card["staging_s"] = on_card["first_batch_wait_s"]
        report["device_corpus"] = on_card
        lap("device_corpus")
        disk = {}
        for name in ("fill", "read"):
            disk[name], _ = _file_fed_run(_corpus_config(
                root, os.path.join(tmp, f"disk_{name}"), epochs=1, device_corpus="off",
                num_workers=4, decode_cache_gb=0.0, decode_disk_cache_gb=2.0,
                checkpoint_every_epochs=0), timed_from=1)
        if any(st["decodes"] or st["disk_hits"] != CORPUS_N
               for st in disk["read"]["io_stats"].values()):
            raise AssertionError(f"the disk cache's reading pass decoded: {disk['read']}")
        report["disk_cache"] = disk
        lap("disk_cache")
        report["stream_checks"] = _stream_checks(root)
        lap("stream_checks")
        c7, _ = _file_fed_run(_corpus_config(root, os.path.join(tmp, "c7"), input_ch=7,
                                             epochs=1, device_corpus="off",
                                             checkpoint_every_epochs=0),
                              timed_from=10**9, max_iterations=1)
        report["input_ch7"] = {k: c7[k] for k in ("iterations", "launches", "losses")}
        lap("input_ch7")
        report["submit"] = _submit_check(root, tmp)
        lap("submit")
    launches = (files["launches"] + on_card["launches"] + disk["fill"]["launches"]
                + disk["read"]["launches"] + c7["launches"] + report["submit"]["launches"])
    emit("corpus", **env, net="drn_d_38", input_ch=6, batch=B, hw=[H, W], dtype="bfloat16",
         num_k=4, samples_per_corpus=CORPUS_N, launches=launches,
         phase_seconds=time.perf_counter() - t_phase, step_seconds=laps, card=smi_line,
         **report,
         note="host decode by the route named in 'decoder'; ms_per_iteration is the "
              "synchronized wall time over the timed iterations under torch.profiler, "
              "idle share = 1 - busy kernel and copy time / that wall time")
    return launches


DEPLOY_TIMED = 5  # artifact and in-process requests timed, each
# the batch-8 artifact against in-process serving, bf16: exact. Both run
# the same kernels in the same order; the first card run (H100 80GB HBM3,
# 700 W) found them equal, so the bounds first set (0.999 of the class-map
# pixels, 2e-2 of probability) were tightened to equality.
DEPLOY_PRED_AGREE_MIN, DEPLOY_PROB_DIFF_MAX = 1.0, 0.0

_FRESH_LOAD = r"""
import json, sys, time
import numpy as np
t0 = time.perf_counter()
from mcseg_tpu_torch.eval.serving import load_serving
call = load_serving(sys.argv[1])
t1 = time.perf_counter()
out = call(dict(np.load(sys.argv[2])))
out = out if isinstance(out, tuple) else (out,)
arrays = {name: o.cpu().numpy() for name, o in zip(call.manifest["outputs"], out)}
t2 = time.perf_counter()
np.savez(sys.argv[3], **arrays)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mcseg_tpu"))
print(json.dumps({"import_and_load_s": t1 - t0, "first_call_s": t2 - t1, "leaked": leaked}))
"""


def _timed_ms(fn, n):
    """Host-clock ms of each of ``n`` calls, each ended by a synchronize."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _profile_request(fn, top=6):
    """One call of ``fn`` under ``torch.profiler``: wall ms, the card's busy
    ms (kernel and copy rows), its idle share, the kernel count, the rows
    of the normalize kernel and ``top`` rows by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA and r.self_device_time_total > 0]
    busy_ms = sum(r.self_device_time_total for r in rows) / 1e3
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    as_dict = lambda r: {"name": r.key[:160], "calls": r.count,  # noqa: E731
                         "ms": r.self_device_time_total / 1e3}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms, "kernel_rows": len(rows),
            "kernel_calls": sum(r.count for r in rows),
            "normalize_kernel": [as_dict(r) for r in rows if "normalize_stack_kernel" in r.key],
            "top": [as_dict(r) for r in rows[:top]]}


def _http_round_trip(path, call1, request):
    """POST /predict of row 0 of ``request`` (RGB PNG and 16-bit mm depth
    PNG) to ``serve_http`` around the batch-1 artifact at ``path``, twice
    (the server's first request also sets up the card's handles on its
    thread); each class map against the artifact's (``call1``) on the
    planes as the server decodes them."""
    import base64
    import io
    import threading
    import urllib.request

    import numpy as np
    from PIL import Image  # the server's geometry check needs it too

    from mcseg_tpu_torch.data.transforms import encode_png
    from mcseg_tpu_torch.native import routes
    from mcseg_tpu_torch.tools import serve_http

    planes = {"image": base64.b64encode(encode_png(request["image"][0])).decode(),
              "depth": base64.b64encode(encode_png(
                  np.round(request["depth"][0] * 1000.0).astype(np.uint16))).decode()}
    body = json.dumps(planes).encode()
    srv = serve_http.make_server(path, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    before = dict(routes)
    trips = []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/predict", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                resp = json.loads(r.read())
            trips.append(((time.perf_counter() - t0) * 1e3, resp))
        by_route = {k: routes[k] - before[k] for k in routes}
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    decoded = {k: serve_http._decode_plane(v, k, H, W)[None] for k, v in planes.items()}
    want = call1(decoded).cpu().numpy()[0]
    for _, resp in trips:
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(resp["pred_png"]))))
        if got.shape != (H, W) or not np.array_equal(got, want.astype(np.uint8)):
            raise AssertionError(f"HTTP class map differs from the artifact's on "
                                 f"{int((got != want).sum())} pixels")
    return {"ms_first": trips[0][0], "ms_second": trips[1][0],
            "decode_route": serve_http.decode_route(), "decoded_by_route": by_route,
            "shape": trips[1][1]["shape"], "classes": len(trips[1][1]["classes"]),
            "body_bytes": len(body)}


def phase_deploy(smi_line):
    """The deployment path on the card, BASELINE config 4's serving model
    (DRN-D-38, RGB+HHA from raw depth, 40 classes, 640x480, bf16, random
    weights from generator seed 0): ``export_serving`` at batch 8 with
    probabilities and at batch 1; each artifact loaded in a fresh
    ``python3`` by ``load_serving`` alone and run once; the batch-8 artifact
    against in-process ``make_serve_fn`` on one request (class-map share
    and largest probability difference); the kernel's launches inside the
    artifact (exactly one per request) and its name among one profiled
    request's kernels; ms per request, artifact and in-process in turns,
    and batch-1 latency; ``bench_serving`` at its default batch 24; one
    HTTP ``/predict`` round trip; ``adapt_test --outdir --saves_prob`` over
    one batch of the model's checkpoint; one ``adapt_train --tb_dir``
    iteration. Everything it writes is under build/deploy_* and removed at
    the end."""
    import contextlib
    import glob
    import io
    import tempfile

    import numpy as np
    import torch

    from mcseg_tpu_torch.cli import adapt_test, adapt_train
    from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
    from mcseg_tpu_torch.eval.serving import export_serving, load_serving, make_serve_fn
    from mcseg_tpu_torch.models.factory import init_models
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.tools import bench_serving
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    cfg = _serve_config("bfloat16")
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    ds = get_dataset("synthetic_shifted", cfg.data, "val")
    raw = stack_samples(ds, range(B))
    request = {"image": raw["image"], "depth": raw["depth"]}
    request1 = {k: v[:1] for k, v in request.items()}
    report = {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="deploy_") as tmp:
        # (a) the two artifacts
        paths = {"b8": os.path.join(tmp, "m.pt2.b8"), "b1": os.path.join(tmp, "m.pt2.b1")}
        manifests = {}
        for name, b, probs in (("b8", B, True), ("b1", 1, False)):
            t0 = time.perf_counter()
            manifests[name] = export_serving(cfg, params, paths[name], batch=b, device=DEVICE,
                                             with_probs=probs)
            report[f"export_{name}_s"] = time.perf_counter() - t0
            spec = manifests[name]["input_spec"]
            if spec != {"image": {"shape": [b, H, W, 3], "dtype": "uint8"},
                        "depth": {"shape": [b, H, W], "dtype": "float32"}}:
                raise AssertionError(f"artifact {name} input spec {spec}")
        report["artifact_bytes"] = {k: m["bytes"] for k, m in manifests.items()}
        report["outputs_b8"] = manifests["b8"]["outputs"]

        # (c) the batch-8 artifact against in-process serving on one request
        call8, call1 = load_serving(paths["b8"]), load_serving(paths["b1"])
        live = make_serve_fn(cfg, params, device=DEVICE, with_probs=True)
        a_pred, a_probs = call8(request)
        l_pred, l_probs = live(request)
        if tuple(a_pred.shape) != (B, H, W) or a_pred.dtype != torch.int32 \
                or tuple(a_probs.shape) != (B, H, W, cfg.model.n_class):
            raise AssertionError(f"artifact outputs {a_pred.shape} {a_pred.dtype} {a_probs.shape}")
        agree = float((a_pred == l_pred).float().mean())
        prob_diff = float((a_probs - l_probs).abs().max())
        report.update(pred_agree_artifact_vs_live=agree, max_prob_diff_artifact_vs_live=prob_diff,
                      artifact_equals_live=agree == 1.0 and prob_diff == 0.0)
        if agree < DEPLOY_PRED_AGREE_MIN or prob_diff > DEPLOY_PROB_DIFF_MAX:
            raise AssertionError(f"artifact vs in-process: class maps agree on {agree}, "
                                 f"probabilities differ by up to {prob_diff}")

        # (b) each artifact in a fresh python3 that loads it through load_serving alone
        fresh = {}
        for name, req in (("b8", request), ("b1", request1)):
            np.savez(os.path.join(tmp, f"req_{name}.npz"), **req)
            out_npz = os.path.join(tmp, f"out_{name}.npz")
            proc = subprocess.run(
                [sys.executable, "-c", _FRESH_LOAD, paths[name],
                 os.path.join(tmp, f"req_{name}.npz"), out_npz],
                cwd=HERE, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"fresh load of {name}: rc {proc.returncode}\n"
                                     f"{proc.stderr[-3000:]}")
            info = json.loads(proc.stdout.strip().splitlines()[-1])
            if info["leaked"]:
                raise AssertionError(f"fresh load of {name} imported {info['leaked']}")
            got = np.load(out_npz)["pred"]
            want = (a_pred if name == "b8" else call1(request1)).cpu().numpy()
            info["pred_agree_with_this_process"] = float((got == want).mean())
            if got.shape != want.shape or info["pred_agree_with_this_process"] < 0.999:
                raise AssertionError(f"fresh load of {name}: {got.shape}, agree "
                                     f"{info['pred_agree_with_this_process']}")
            fresh[name] = info
        report["fresh_process"] = fresh

        # (d) the kernel runs inside the artifact: one launch per request
        fused_normalize_stack.launches = 0
        for i in range(3):
            call8(request)
            if fused_normalize_stack.launches != i + 1:
                raise AssertionError(f"artifact request {i}: normalize kernel launched "
                                     f"{fused_normalize_stack.launches} times in total")
        artifact_launches = fused_normalize_stack.launches
        if DEVICE == "cuda":
            prof = {"artifact": _profile_request(lambda: call8(request)),
                    "live": _profile_request(lambda: live(request)),
                    "artifact_b1": _profile_request(lambda: call1(request1))}
            hits = prof["artifact"]["normalize_kernel"]
            if len(hits) != 1 or hits[0]["calls"] != 1:
                raise AssertionError(f"normalize_stack_kernel in the artifact's profile: {hits}")
            report["profile"] = prof

        # (e) ms per batch-8 request with probabilities, the artifact and
        # in-process serving (the same work) in turns, then batch-1 latency
        times = {"live": [], "artifact": []}
        for order in (("live", "artifact"), ("artifact", "live")):
            for name in order:
                fn = (lambda: live(request)) if name == "live" else (lambda: call8(request))
                times[name] += _timed_ms(fn, DEPLOY_TIMED)
        report["ms_per_request_b8"] = {k: statistics.median(v) for k, v in times.items()}
        report["ms_per_request_b8_all"] = times
        report["artifact_over_live"] = (report["ms_per_request_b8"]["artifact"]
                                        / report["ms_per_request_b8"]["live"])
        call1(request1)  # warm-up at batch 1
        b1 = _timed_ms(lambda: call1(request1), DEPLOY_TIMED)
        report["ms_per_request_b1"] = statistics.median(b1)
        report["ms_per_request_b1_all"] = b1

        # (f) the serving bench at its defaults (batch 24)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report["bench_serving"] = bench_serving.main([], device=DEVICE)

        # (g) one HTTP round trip around the batch-1 artifact
        report["http"] = _http_round_trip(paths["b1"], call1, request)

        # (h) the tester's dumps through the test command, one batch
        ckpt = os.path.join(tmp, "ckpt", "last")
        os.makedirs(os.path.dirname(ckpt))
        save_checkpoint(ckpt, create_train_state(cfg.model, cfg.train, 0, DEVICE, params=params),
                        cfg)
        dump = os.path.join(tmp, "dumps")
        fused_normalize_stack.launches = 0
        with contextlib.redirect_stdout(io.StringIO()):
            miou = adapt_test.main([ckpt, "--outdir", dump, "--saves_prob",
                                    "--max_samples", str(B)], device=DEVICE)
        names = sorted(os.listdir(dump))
        counts = {k: sum(n.endswith(k) for n in names)
                  for k in ("_label.png", "_color.png", "_prob.npy")}
        probs = np.load(os.path.join(dump, "000000_prob.npy"))
        if counts != {k: B for k in counts} or len(names) != 3 * B \
                or probs.shape != (H, W, cfg.model.n_class) or probs.dtype != np.float16:
            raise AssertionError(f"dumps {counts}, prob {probs.shape} {probs.dtype}")
        if fused_normalize_stack.launches != 1 or not np.isfinite(miou):
            raise AssertionError(f"adapt_test --outdir: {fused_normalize_stack.launches} "
                                 f"launches, mIoU {miou}")
        report["dumps"] = {"files": counts, "prob_shape": list(probs.shape),
                           "prob_dtype": str(probs.dtype), "launches": 1,
                           "prob_sum_max_err": float(np.abs(
                               probs.astype(np.float32).sum(-1) - 1).max())}

        # (i) one training iteration with --tb_dir
        tb_dir, run_dir = os.path.join(tmp, "tb"), os.path.join(tmp, "run")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            adapt_train.main(["synthetic", "synthetic_shifted", "--num_k", "4"]
                             + _cli_argv(run_dir) + ["--max_samples", str(B),
                                                     "--tb_dir", tb_dir], device=DEVICE)
        events = glob.glob(os.path.join(tb_dir, "events.out.tfevents.*"))
        warning = [ln for ln in out.getvalue().splitlines() if ln.startswith("warning: --tb_dir")]
        if events and os.path.getsize(events[0]) > 0:
            report["tb"] = "written"
        elif warning:
            report["tb"] = warning[0]
        else:
            raise AssertionError(f"--tb_dir wrote no events and no warning:\n"
                                 f"{out.getvalue()[-2000:]}")
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit("deploy", net=cfg.model.net, input_ch=6, n_class=40, batch=B, hw=[H, W],
         dtype="bfloat16", launches=artifact_launches, card=smi_line,
         bounds={"pred_agree_min": DEPLOY_PRED_AGREE_MIN,
                 "prob_diff_max": DEPLOY_PROB_DIFF_MAX},
         note="random weights; host-clock ms with a synchronize after each request; "
              "ms_per_request_b8 includes the softmax probabilities on both sides",
         **report)
    return artifact_launches


INTEROP_VAL_N = 2 * B  # NYU-layout val samples phase ``interop`` writes: 2 eval batches


def _reference_keys(sd, fc=False):
    """``sd`` (a port state dict) under reference-style names, in its own
    order: ``base.<i>.<leaf>`` per module, as a torch trunk's Sequential
    names them; a bare ImageNet trunk also carries an ``fc`` head."""
    import torch

    mods, out = {}, {}
    for key, t in sd.items():
        mod, _, leaf = key.rpartition(".")
        out[f"base.{mods.setdefault(mod, len(mods))}.{leaf}"] = t.clone()
    if fc:
        g = torch.Generator().manual_seed(1)
        out["fc.weight"] = torch.randn(1000, 512, 1, 1, generator=g)
        out["fc.bias"] = torch.randn(1000, generator=g)
    return out


def _write_nyu_val(root):
    """An NYU-layout val split of INTEROP_VAL_N samples at H x W, the NYU
    reader's decode size (RGB, raw label, 16-bit depth in mm), from the
    port's procedural generator, named ``000000.png``... as the tester
    names its dumps."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import get_dataset

    corpus = get_dataset("synthetic_shifted", DataConfig(
        test_img_shape=(W, H), max_samples=INTEROP_VAL_N), "val")

    def sample(i):
        s = corpus[i]
        for sub, arr in (("val_rgb", s["image"]), ("val_label", s["label"]),
                         ("val_depth", np.round(s["depth"] * 1000.0).astype(np.uint16))):
            os.makedirs(os.path.join(root, "nyu", sub), exist_ok=True)
            with open(os.path.join(root, "nyu", sub, f"{i:06d}.png"), "wb") as f:
                f.write(_png(arr))

    with ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        list(ex.map(sample, range(INTEROP_VAL_N)))


def _equal_params(a, b, what):
    """Raise unless the two ``{"G", "F1", "F2"...}`` state dicts hold the
    same tensors bit for bit (flax keeps no ``num_batches_tracked``)."""
    import torch

    if a.keys() != b.keys():
        raise AssertionError(f"{what}: modules {sorted(a)} vs {sorted(b)}")
    n = 0
    for name in a:
        keys = [k for k in a[name] if not k.endswith("num_batches_tracked")]
        if sorted(keys) != sorted(k for k in b[name] if not k.endswith("num_batches_tracked")):
            raise AssertionError(f"{what}: {name} keys differ")
        for k in keys:
            x, y = a[name][k], b[name][k]
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {name}.{k} differs")
            n += 1
    return n


def phase_interop(smi_line):
    """Checkpoint interop and the result tools on the card, BASELINE
    config 4's model (DRN-D-38, RGB+HHA from raw depth, 40 classes,
    640x480, batch 8, bf16, seed-0 weights): a reference-format torch
    checkpoint made from the seed-0 weights (reference-style names,
    ``g/f1/f2_state_dict``, ``epoch`` 7, the heads' ``up.`` tensors) and a
    bare 3-channel trunk (with an ImageNet ``fc``) imported by
    ``import_torch.main``, every tensor held bit for bit against its source
    and the widened first conv against the RGB mean; ``parity_eval`` of the
    reference checkpoint on an NYU-layout val split the phase writes (the
    kernel launched once per eval batch), its ``--outdir`` dumps scored by
    ``evaluate_preds`` (the tester's mIoU exactly) and tiled by
    ``make_result_sheet``; the imported state through ``.pt`` ->
    ``.msgpack`` -> ``.pt`` bit for bit, ``adapt_test`` of the
    ``.msgpack`` prefix giving the ``.pt`` prefix's class maps exactly;
    ``summarize_run`` of a 2-iteration ``adapt_train`` run. Everything it
    writes is under build/interop_* and removed at the end."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from mcseg_tpu_torch.cli import adapt_test, adapt_train, evaluate_preds, import_torch
    from mcseg_tpu_torch.models.factory import init_models, widen_first_conv_params
    from mcseg_tpu_torch.ops.normalize import fused_normalize_stack
    from mcseg_tpu_torch.tools import make_result_sheet, parity_eval, summarize_run
    from mcseg_tpu_torch.utils.checkpoint import (
        load_checkpoint, load_params, save_checkpoint, save_jax_checkpoint)

    t_phase = time.perf_counter()
    cfg = _serve_config("bfloat16")
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    cfg3 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, input_ch=3))
    trunk3 = init_models(cfg3.model, torch.Generator().manual_seed(0))["G"]
    seconds, report = {}, {}
    quiet = contextlib.redirect_stdout(io.StringIO())

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"), prefix="interop_") as tmp:
        # (a) the two reference checkpoints, imported
        ref = os.path.join(tmp, "ref.pth.tar")
        up = torch.zeros(40, 1, 16, 16)  # a reference head's fixed upsample, dropped
        torch.save({"epoch": 7, "args": {"net": "drn_d_38", "input_ch": 6},
                    "g_state_dict": _reference_keys(params["G"]),
                    "f1_state_dict": {**_reference_keys(params["F1"]), "up.weight": up},
                    "f2_state_dict": {**_reference_keys(params["F2"]), "up.weight": up}}, ref)
        bare = os.path.join(tmp, "imagenet.pth")
        torch.save(_reference_keys(trunk3, fc=True), bare)
        flags = ["--net", cfg.model.net, "--input_ch", "6", "--n_class", "40",
                 "--dtype", cfg.model.dtype]
        shape = ["--test_img_shape", *map(str, cfg.data.test_img_shape)]
        imported = os.path.join(tmp, "imported", "ref")
        with quiet:
            timed("import_reference", lambda: import_torch.main(
                [ref, imported, *flags], device=DEVICE))
            timed("import_bare_trunk", lambda: import_torch.main(
                [bare, os.path.join(tmp, "imported", "bare"), *flags], device=DEVICE))
        got, got_cfg = load_params(imported)
        report["imported_tensors"] = _equal_params(got, params, "reference import")
        if got_cfg.model.input_ch != 6 or got_cfg.model.net != cfg.model.net:
            raise AssertionError(f"imported config {got_cfg.model}")
        widened, _ = load_params(os.path.join(tmp, "imported", "bare"))
        k3 = trunk3["conv0.weight"]
        k6 = widened["G"]["conv0.weight"]
        mean_err = float((k6[:, 3:] - k3.mean(1, keepdim=True)).abs().max())
        if not torch.equal(k6[:, :3], k3) or not torch.equal(k6, widen_first_conv_params(k3, 6)) \
                or mean_err > 1e-6:
            raise AssertionError(f"widened first conv: RGB slice kept "
                                 f"{torch.equal(k6[:, :3], k3)}, HHA vs RGB mean {mean_err}")
        rest = {k: v for k, v in widened["G"].items() if k != "conv0.weight"}
        report["bare_trunk_tensors"] = 1 + _equal_params(
            {"G": rest}, {"G": {k: v for k, v in trunk3.items() if k != "conv0.weight"}},
            "bare trunk import")
        report["widened_hha_vs_rgb_mean_max_err"] = mean_err

        # (b) parity_eval on a written NYU val split, with --outdir
        root, dumps = os.path.join(tmp, "corpora"), os.path.join(tmp, "dumps")
        timed("write_val_split", lambda: _write_nyu_val(root))
        kept = os.path.join(tmp, "parity", "imported")
        fused_normalize_stack.launches = 0
        with quiet:
            miou = timed("parity_eval", lambda: parity_eval.main(
                [ref, "--dataset", "nyu", "--data_root", root, *flags, *shape,
                 "--batch_size", str(B), "--keep_import", kept, "--outdir", dumps],
                device=DEVICE))
        interop_launches = fused_normalize_stack.launches
        n_batches = -(-INTEROP_VAL_N // B)
        if interop_launches != n_batches or not np.isfinite(miou):
            raise AssertionError(f"parity_eval: {interop_launches} launches in {n_batches} "
                                 f"eval batches, mIoU {miou}")
        report.update(parity_miou=miou, eval_batches=n_batches)

        # (c) evaluate_preds on the dumps, and the result sheets
        gt = os.path.join(root, "nyu", "val_label")
        with quiet:
            scored = timed("evaluate_preds", lambda: evaluate_preds.main(
                [dumps, gt, "--gt_raw"], device=DEVICE))
            sheets = timed("make_result_sheet", lambda: make_result_sheet.main(
                [os.path.join(root, "nyu", "val_rgb"), gt, dumps,
                 os.path.join(tmp, "sheets"), "--limit", str(INTEROP_VAL_N)]))
        if scored != miou:
            raise AssertionError(f"evaluate_preds mIoU {scored} != the tester's {miou}")
        if len(sheets) != INTEROP_VAL_N:
            raise AssertionError(f"{len(sheets)} result sheets for {INTEROP_VAL_N} dumps")
        report.update(evaluate_preds_miou=scored, sheets=len(sheets),
                      sheet_hw=list(_png_size(sheets[0])))

        # (d) .pt -> .msgpack -> .pt, and the tester on the .msgpack prefix
        state, state_cfg = load_checkpoint(kept, DEVICE)
        jax_prefix = os.path.join(tmp, "jax", "last")
        timed("write_msgpack", lambda: save_jax_checkpoint(jax_prefix, state, state_cfg))
        back, _ = timed("read_msgpack", lambda: load_checkpoint(jax_prefix, DEVICE))
        again = os.path.join(tmp, "again", "last")
        save_checkpoint(again, back, state_cfg)
        report["round_trip_tensors"] = _equal_params(load_params(again)[0], load_params(kept)[0],
                                                     ".pt -> .msgpack -> .pt")
        if back.step != state.step:
            raise AssertionError(f"round trip step {back.step} != {state.step}")
        report["checkpoint_bytes"] = {"pt": os.path.getsize(kept + ".pt"),
                                      "msgpack": os.path.getsize(jax_prefix + ".msgpack")}
        del state, back
        jax_dumps = os.path.join(tmp, "jax_dumps")
        fused_normalize_stack.launches = 0
        with quiet:
            jax_miou = timed("adapt_test_msgpack", lambda: adapt_test.main(
                [jax_prefix, "nyu", "--data_root", root, "--split", "val", *shape,
                 "--batch_size", str(B), "--outdir", jax_dumps], device=DEVICE))
        msgpack_launches = fused_normalize_stack.launches
        labels = sorted(n for n in os.listdir(dumps) if n.endswith("_label.png"))
        same = [open(os.path.join(dumps, n), "rb").read()
                == open(os.path.join(jax_dumps, n), "rb").read() for n in labels]
        if len(labels) != INTEROP_VAL_N or not all(same) or jax_miou != miou \
                or msgpack_launches != n_batches:
            raise AssertionError(f"adapt_test of the .msgpack prefix: {sum(same)} of "
                                 f"{len(labels)} class maps equal, mIoU {jax_miou} vs {miou}, "
                                 f"{msgpack_launches} launches")
        report["msgpack_class_maps_equal"] = len(labels)

        # (e) summarize_run of a 2-iteration run
        run_dir = os.path.join(tmp, "run")
        with quiet:
            timed("train_adapt_2_iterations", lambda: adapt_train.main(
                ["synthetic", "synthetic_shifted", "--num_k", "4"] + _cli_argv(run_dir),
                device=DEVICE))
        summary = timed("summarize_run", lambda: summarize_run.summarize(run_dir)).splitlines()
        if not any(ln.startswith("steps logged: 2 ") for ln in summary) \
                or f"resume with: --resume {os.path.join(run_dir, 'last')}" not in summary:
            raise AssertionError("summarize_run:\n" + "\n".join(summary))
        report["summary_lines"] = len(summary)
    seconds["phase"] = time.perf_counter() - t_phase
    emit("interop", net=cfg.model.net, input_ch=6, n_class=40, batch=B, hw=[H, W],
         dtype=cfg.model.dtype, card=smi_line, interop_launches=interop_launches,
         step_seconds=seconds, **report)
    return interop_launches


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        sys.exit("chip_smoke: torch is not installed")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this needs an NVIDIA card")
    import mcseg_tpu_torch

    pkg = os.path.dirname(os.path.abspath(mcseg_tpu_torch.__file__))
    if pkg != os.path.join(HERE, "mcseg_tpu_torch"):
        sys.exit(f"chip_smoke: mcseg_tpu_torch comes from {pkg}, not this checkout")

    smi_line = phase_env()
    phase_build()
    main_case, train_case, c7_case = phase_kernels()
    launches = phase_serve(smi_line)
    if launches == 0:
        raise AssertionError("the serving path never launched fused_normalize_stack")
    phase_eval()
    train_launches, staged_ms = phase_train(smi_line)
    multitask_launches = phase_multitask(smi_line)
    cli_launches = phase_cli(smi_line)
    family_launches = phase_families(smi_line)
    corpus_launches = phase_corpus(smi_line, staged_ms)
    deploy_launches = phase_deploy(smi_line)
    interop_launches = phase_interop(smi_line)
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{
        "name": "fused_normalize_stack", "route": "cuda", "source": KERNEL_SRC,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "share_of_bound": main_case["share_of_bound"],
        "train_launches": train_launches, "multitask_launches": multitask_launches,
        "cli_launches": cli_launches,
        "family_launches": family_launches, "corpus_launches": corpus_launches,
        "deploy_launches": deploy_launches, "interop_launches": interop_launches,
        "train_case_ms": train_case["kernel_ms"],
        "train_case_share_of_bound": train_case["share_of_bound"],
        "c7_case_ms": c7_case["kernel_ms"], "c7_case_bound_ms": c7_case["bound_ms"],
        "c7_case_share_of_bound": c7_case["share_of_bound"]}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
