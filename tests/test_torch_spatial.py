"""Spatial partitioning's building blocks (``mcseg_tpu_torch/parallel/spatial.py``)
over 4 gloo CPU ranks in one row-block layout (1 data block x 4 row blocks),
spawned once for the module, against the unsplit ops; and the layouts the
port refuses.

Float64. DRN's conv cases (k, stride, dilation): the 7x7 stem, 3x3 at
dilation 1, 2 and 4, the stride-2 3x3 and the 1x1 projections, on a map of
8 rows (2 per rank), so the 7x7's halo of 3 rows and dilation 4's of 4 span
more than one neighbouring block. The 8x upsample in both modes on a map of
4 rows (one per rank). The other trunks' row-split parts: PSPNet's stem
max pool on input that is mostly exact zeros (ties with the edge row
above the image), FCN8s's 2x2 ceil-mode pool, PSPNet's ``PyramidPooling``
at narrow widths (cin 8, ``reduce_ch`` 8) on a 12x12 map, where bins 3
and 6 straddle the 3-row blocks, on an 8x6 map, where bins 3 and 6 take
the resize path, and on the 12x12 map in a 2 data blocks x 2 row blocks
layout of the 4 ranks (the branches' BN reduces over copies and images),
and FCN8s's decoder (2x fuses and the 8x upsample)
in both upsample modes. Bound: each rank's output rows and input gradient,
the sum of the ranks' parameter gradients and every rank's BatchNorm
statistics within 1e-12 of the unsplit op's (relative to each tensor's
largest magnitude). The dropout masks of FCN8s at 2 data blocks x 2 row
blocks need no collective: each rank's ``SeededMasks`` draw is held to its
share of one process's.
"""

import argparse
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parallel_worker import Ranks, _module_grads, row_split_module
from mcseg_tpu_torch.cli import adapt_train, argparse_compat, multitask_train, source_train
from mcseg_tpu_torch.losses.seg import boundary_targets_from_labels
from mcseg_tpu_torch.models.fcn_vgg import SeededMasks
from mcseg_tpu_torch.models.psp_net import stem_pool
from mcseg_tpu_torch.ops.upsample import upsample_logits
from mcseg_tpu_torch.parallel import multihost
from mcseg_tpu_torch.parallel.mesh import DataParallel, batch_rows, data_blocks, world_size
from mcseg_tpu_torch.parallel.spatial import (
    _halo_index, across_data, check_spatial, shard_rows)
from mcseg_tpu_torch.train import loops
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

SPACE = 4
REL = 1e-12
CONV_CASES = [(7, 1, 1), (3, 1, 1), (3, 2, 1), (3, 1, 2), (3, 1, 4), (1, 2, 1), (1, 1, 1)]
B, C, H, W = 2, 3, 8, 5
UP_H, FACTOR = 4, 8
# (h, w, row blocks): the 2-block case lays the ranks out as 2 data blocks x 2
# row blocks, where each branch's BN sees two copies of two images
PPM_CASES = {"12x12_exact_bins": (12, 12, SPACE), "8x6_resized_bins": (8, 6, SPACE),
             "12x12_2x2_layout": (12, 12, 2)}
FCN_H, FCN_W, FCN_CLASSES = 128, 32, 3  # /32: one row per rank


def _close(got, want, what):
    err = float((got - want).abs().max() / max(float(want.abs().max()), 1e-300))
    assert err <= REL, f"{what}: relative error {err:.3g}"


@pytest.fixture(scope="module")
def cases():
    rng = np.random.RandomState(0)
    convs = []
    for k, stride, dilation in CONV_CASES:
        x = rng.randn(B, C, H, W)
        w = rng.randn(4, C, k, k)
        probe = rng.randn(B, 4, H // stride, -(-W // stride))
        convs.append((x, probe, w, stride, dilation))
    up_x = rng.randn(B, C, UP_H, W)
    up_probe = rng.randn(B, C, UP_H * FACTOR, W * FACTOR)
    pool_x = np.maximum(rng.randn(B, C, H, 7) - 1.0, 0.0)  # ~84% exact zeros
    pool_x[:, :, 0] = 0.0  # every window at the top ties with the edge row
    stem = (pool_x, rng.randn(B, C, H // 2, 4))
    ceil = (rng.randn(B, C, H, W), rng.randn(B, C, H // 2, -(-W // 2)))
    modules = [_module_case(rng, "ppm", dict(cin=8, reduce_ch=8), [(B, 8, h, w)], (B, 8, h, w),
                            space) for h, w, space in PPM_CASES.values()]
    fcn_feats = [(B, 256, FCN_H // 8, FCN_W // 8), (B, 512, FCN_H // 16, FCN_W // 16),
                 (B, 4096, FCN_H // 32, FCN_W // 32)]
    modules += [_module_case(rng, "fcn", dict(n_class=FCN_CLASSES, upsample=mode), fcn_feats,
                             (B, FCN_CLASSES, FCN_H, FCN_W), SPACE)
                for mode in ("convt", "resize")]
    ranks = Ranks([("halo", dict(space=SPACE, convs=convs, upsample=(up_x, up_probe, FACTOR),
                                 stem_pool=stem, ceil_pool=ceil, modules=modules))],
                  world=SPACE)
    return {"convs": convs, "upsample": (up_x, up_probe), "stem_pool": stem,
            "ceil_pool": ceil, "modules": modules, "ranks": ranks.results()}


def _module_case(rng, kind, kw, input_shapes, probe_shape, space):
    """(kind, params, kw, inputs, probe, space) of ``row_split_module``:
    random float64 parameters (positive BatchNorm scales and variances),
    inputs and probe, in a layout of ``space`` row blocks."""
    params = {}
    for k, v in row_split_module(kind, None, **kw).state_dict().items():
        if not v.is_floating_point():
            params[k] = v.numpy()
        elif k.endswith("running_var") or "bn" in k and k.endswith("weight"):
            params[k] = 1.0 + 0.5 * rng.rand(*v.shape)
        else:
            params[k] = 0.3 * rng.randn(*v.shape)
    return (kind, params, kw, [rng.randn(*s) for s in input_shapes], rng.randn(*probe_shape),
            space)


def _unsplit(fn, x, probe, weight=None):
    x = torch.from_numpy(x).requires_grad_(True)
    w = None if weight is None else torch.from_numpy(weight).requires_grad_(True)
    y = fn(x, w)
    (y * torch.from_numpy(probe)).sum().backward()
    return y.detach(), x.grad, None if w is None else w.grad


def _rows(t, rank, dim=2, space=SPACE):
    """Rank ``rank``'s share of ``t`` in a layout of ``space`` row blocks:
    its data block's images (of SPACE // space), then its rows."""
    blocks = SPACE // space
    t = t.narrow(0, rank // space * t.shape[0] // blocks, t.shape[0] // blocks)
    n = t.shape[dim] // space
    return t.narrow(dim, rank % space * n, n)


@pytest.mark.parametrize("case", range(len(CONV_CASES)),
                         ids=[f"k{k}s{s}d{d}" for k, s, d in CONV_CASES])
def test_halo_conv_equals_the_unsplit_conv(cases, case):
    x, probe, w, stride, dilation = cases["convs"][case]
    pad = dilation * (w.shape[-1] // 2)
    y, dx, dw = _unsplit(lambda t, wt: F.conv2d(t, wt, stride=stride, padding=pad,
                                                dilation=dilation), x, probe, w)
    got = [r[0]["convs"][case] for r in cases["ranks"]]
    for rank, g in enumerate(got):
        _close(g["y"], _rows(y, rank), f"rank {rank} output")
        _close(g["dx"], _rows(dx, rank), f"rank {rank} input gradient")
    _close(sum(g["grads"]["weight"] for g in got), dw, "weight gradient")


@pytest.mark.parametrize("mode", ["convt", "resize"])
def test_row_split_upsample_equals_the_unsplit_upsample(cases, mode):
    x, probe = cases["upsample"]
    y, dx, _ = _unsplit(lambda t, _: upsample_logits(t, FACTOR, mode), x, probe)
    for rank, r in enumerate(cases["ranks"]):
        g = r[0]["upsample"][mode]
        assert g["y"].shape == (B, C, UP_H * FACTOR // SPACE, W * FACTOR)
        _close(g["y"], _rows(y, rank), f"rank {rank} {mode} output")
        _close(g["dx"], _rows(dx, rank), f"rank {rank} {mode} input gradient")


@pytest.mark.parametrize("mode,node", [
    ("convt", "GeneratedBackwardFor_mcseg_upsample_convt_defaultBackward"),
    ("resize", "UpsampleBilinear2DBackward0")])
def test_row_split_upsample_spans_its_backward_and_the_halo(cases, mode, node):
    """Under the profiler each rank's row-split upsample records one forward
    and one backward ``upsample`` span in its root, and the backward span
    holds the op's node and the halo exchange's backward."""
    for r in cases["ranks"]:
        spans = r[0]["upsample"][mode]["spans"]
        (fwd_root, bwd_root) = (root for _, root in spans["records"])
        assert [b for b, _ in spans["records"]] == [False, True] and fwd_root == bwd_root == 0
        assert {node, "_HaloBackward"} <= set(spans["nodes"])


def test_stem_pool_with_exact_zeros_equals_the_unsplit_pool(cases):
    x, probe = cases["stem_pool"]
    y, dx, _ = _unsplit(lambda t, _: stem_pool(t), x, probe)
    assert (x == 0).mean() > 0.8
    for rank, r in enumerate(cases["ranks"]):
        g = r[0]["stem_pool"]
        _close(g["y"], _rows(y, rank), f"rank {rank} output")
        _close(g["dx"], _rows(dx, rank), f"rank {rank} input gradient")


def test_ceil_pool_of_a_row_block_equals_the_unsplit_pool(cases):
    x, probe = cases["ceil_pool"]
    y, dx, _ = _unsplit(lambda t, _: F.max_pool2d(t, 2, 2, ceil_mode=True), x, probe)
    for rank, r in enumerate(cases["ranks"]):
        g = r[0]["ceil_pool"]
        _close(g["y"], _rows(y, rank), f"rank {rank} output")
        _close(g["dx"], _rows(dx, rank), f"rank {rank} input gradient")


def _module_equals_the_unsplit_module(cases, i):
    kind, params, kw, inputs, probe, space = cases["modules"][i]
    want = _module_grads(row_split_module(kind, params, **kw),
                         [torch.from_numpy(x) for x in inputs], torch.from_numpy(probe))
    got = [r[0]["modules"][i] for r in cases["ranks"]]
    for rank, g in enumerate(got):
        _close(g["y"], _rows(want["y"], rank, space=space), f"rank {rank} output")
        for j, (dx, wdx) in enumerate(zip(g["dx"], want["dx"])):
            _close(dx, _rows(wdx, rank, space=space), f"rank {rank} gradient of input {j}")
        for k, b in want["buffers"].items():
            _close(g["buffers"][k], b, f"rank {rank} {k}")
    for k, w in want["grads"].items():
        _close(sum(g["grads"][k] for g in got), w, f"gradient of {k}")


@pytest.mark.parametrize("case", range(len(PPM_CASES)), ids=list(PPM_CASES))
def test_pyramid_pooling_equals_the_unsplit_module(cases, case):
    _module_equals_the_unsplit_module(cases, case)


@pytest.mark.parametrize("mode", ["convt", "resize"])
def test_fcn8s_decoder_equals_the_unsplit_decoder(cases, mode):
    _module_equals_the_unsplit_module(cases, len(PPM_CASES) + ["convt", "resize"].index(mode))


def test_seeded_masks_keep_the_ranks_images_and_rows():
    """2 data blocks x 2 row blocks: each rank's keep-mask is its data
    block's images and its row block of one process's mask, step for step."""
    shape = (4, 6, 8, 3)  # the global batch's [B, C, H/32, W/32]
    one = SeededMasks(5, "cpu")
    ranks = [SeededMasks(5, "cpu", DataParallel(rank=r, world=4, device=torch.device("cpu"),
                                                space=2)) for r in range(4)]
    for step in (0, 3):
        for m in [one] + ranks:
            m.reseed(step)
        for _ in range(2):  # the generator advances in call order
            want = one(shape, torch.device("cpu"))
            for r, m in enumerate(ranks):
                got = m((2, 6, 4, 3), torch.device("cpu"))
                assert torch.equal(got, want[2 * (r // 2):2 * (r // 2) + 2, :,
                                             4 * (r % 2):4 * (r % 2) + 4]), (step, r)


def test_the_layout_keeps_two_counts_apart():
    dps = [DataParallel(rank=r, world=8, device=torch.device("cpu"), space=4)
           for r in range(8)]
    assert [(d.data_rank, d.space_rank) for d in dps[3:6]] == [(0, 3), (1, 0), (1, 1)]
    assert data_blocks(dps[0]) == 2 and world_size(dps[0]) == 8
    # the ranks of a data block hold the same images; the blocks split the batch
    assert [list(batch_rows(d, 4)) for d in dps[2:6]] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    with pytest.raises(ValueError, match="data blocks"):
        batch_rows(dps[0], 3)
    scoring = across_data(dps[5])
    assert (scoring.rank, scoring.world, scoring.space) == (1, 2, 1)
    plain = DataParallel(rank=1, world=2, device=torch.device("cpu"))
    assert across_data(plain) is plain and across_data(None) is None


def test_a_halo_taller_than_a_block_reads_several_ranks():
    dp = DataParallel(rank=1, world=4, device=torch.device("cpu"), space=4)
    # 1 row per block, dilation 4: rows -3..0 above rank 1 and 2..5 below;
    # slot (rank * 2 + top/bottom) * block + offset, 8 = a zero row
    assert _halo_index(dp, 1, 1, 4, 4, False).tolist() == [8, 8, 8, 0, 4, 6, 8, 8]
    # the resize's edge rows repeat the image's first and last rows
    dp0 = DataParallel(rank=0, world=4, device=torch.device("cpu"), space=4)
    assert _halo_index(dp0, 2, 1, 1, 1, True).tolist() == [0, 2]


def test_boundary_targets_come_from_whole_labels_at_a_shard_edge():
    """A class edge on the rows beside a block boundary marks both rows;
    derived from a row block alone, the block's edge row would lose it."""
    labels = torch.zeros(1, 8, 4, dtype=torch.int32)
    labels[:, 4:] = 3  # the edge lies between rows 3 and 4, the blocks' boundary
    dp = DataParallel(rank=1, world=2, device=torch.device("cpu"), space=2)
    targets, valid = loops._row_split_boundary(dp, labels, boundary_weight=1.0)
    whole, _ = boundary_targets_from_labels(labels)
    assert torch.equal(targets, whole[:, 4:]) and targets[0, 0].sum() == 4
    alone, _ = boundary_targets_from_labels(shard_rows(dp, labels)[0])
    assert alone.sum() == 0
    assert loops._row_split_boundary(dp, labels, boundary_weight=0.0) is None


def _argv(tmp_path, extra):
    return (f"synthetic synthetic_shifted --net drn_d_14 --dtype float32 --batch_size 2 "
            f"--train_img_shape 32 32 --max_samples 2 --epochs 1 --num_k 1 "
            f"--out_dir {tmp_path / 'run'} " + extra).split()


@pytest.mark.parametrize("extra,error,match", [
    ("--spatial_devices 2", ValueError, "does not divide the 1 rank"),
    ("--spatial_devices 3 --train_img_shape 32 48 --coordinator 127.0.0.1:1 "
     "--num_processes 2 --process_id 0",
     ValueError, "does not divide the 2 rank"),
    ("--spatial_devices 4 --train_img_shape 32 48", ValueError, "multiple of 32"),
    ("--spatial_devices 2 --net fcn8s_vgg16", ValueError,
     r"height 32 .* H/32 each split .* multiple of 64 \(32x2\)"),
], ids=["one_process", "ranks", "height", "fcn8s"])
def test_refused_layouts_raise_before_anything_is_written(extra, error, match, tmp_path):
    with pytest.raises(error, match=match):
        adapt_train.main(_argv(tmp_path, extra), device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_every_trainer_command_refuses_before_joining(tmp_path, monkeypatch):
    """The refusals come before a group is joined: nothing waits for ranks.
    FCN8s at 480 rows does not split in 2 (480 / 64 = 7.5)."""
    joined = []
    monkeypatch.setattr(multihost, "initialize", lambda *a, **kw: joined.append(a))
    for main, argv in ((source_train.main, "synthetic"), (multitask_train.main,
                                                           "synthetic synthetic_shifted")):
        with pytest.raises(ValueError, match=r"height 480 .* multiple of 64 \(32x2\)"):
            main(f"{argv} --net fcn8s_vgg16 --train_img_shape 640 480 --spatial_devices 2 "
                 f"--multihost --out_dir {tmp_path / 'run'}".split(), device="cpu")
    assert not joined and not os.path.exists(tmp_path / "run")


def test_the_loops_refuse_what_the_commands_refuse():
    check_spatial("drn_d_22", 32, 4)  # H/8 = 4 rows: one per block
    check_spatial("psp", 30, 1)  # no layout, nothing to refuse
    with pytest.raises(ValueError, match="multiple of 16"):
        check_spatial("drn_c_26", 24, 2)
    check_spatial("pspnet", 480, 2)  # PSPNet keeps DRN's 8 x the blocks
    check_spatial("fcn8s_vgg16", 512, 4)  # 1024x512 splits in 2 and in 4
    with pytest.raises(ValueError, match=r"H/16, H/32 .* multiple of 64 \(32x2\)"):
        check_spatial("fcn8s_vgg16", 480, 2)
    ns = argparse.Namespace(spatial_devices=2, net="fcn8s", train_img_shape=[32, 32])
    with pytest.raises(ValueError, match="multiple of 64"):
        argparse_compat.reject_unported(ns)
    argparse_compat.reject_unported(  # accepted: joins a group next
        argparse.Namespace(spatial_devices=2, net="psp", train_img_shape=[640, 480]))
    argparse_compat.reject_unported(types.SimpleNamespace(net="psp"))  # a testing parser
