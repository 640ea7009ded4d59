"""The port's data-parallel helpers without a group (``parallel/``), the
rows a rank holds, and the inputs the ranks of a job draw and decode.

Mirrors the single-process and row-placement checks of the JAX package's
``tests/test_multihost.py``: without a group every helper is a no-op and
the run is the plain one; rank r holds the contiguous block r of a global
batch (as ``P('data')`` places rows) and a batch the ranks do not divide
is refused; a rank's host pipeline decodes exactly its rows, bit-equal to
those rows of the full decode, and its card-resident corpus gathers the
same; its crop and flip draws and its dropout masks are its rows of one
process's. Nothing here needs a second process: the rows depend only on
(rank, world), which a ``DataParallel`` without a joined group carries.
"""

import argparse

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
from mcseg_tpu_torch.data.datasets import ZipDataset, get_dataset
from mcseg_tpu_torch.data.device_corpus import corpus_stream
from mcseg_tpu_torch.data.pipeline import batch_iterator
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.models.fcn_vgg import SeededMasks
from mcseg_tpu_torch.ops.preprocess import pre_crop_canvas
from mcseg_tpu_torch.parallel import mesh, multihost
from mcseg_tpu_torch.parallel.mesh import DataParallel, local_batch_rows
from mcseg_tpu_torch.train import loops
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

CPU = torch.device("cpu")


def _rank(rank, world=2):
    return DataParallel(rank=rank, world=world, device=CPU)


def test_single_process_helpers_are_no_ops():
    assert not dist.is_initialized()
    assert multihost.is_primary()
    multihost.sync()
    args = argparse.Namespace(multihost=False, coordinator=None, num_processes=None,
                              process_id=None)
    with multihost.maybe_initialize_from_args(args, "cpu") as dp:
        assert dp is None and not dist.is_initialized()
    x = torch.randn(3, requires_grad=True)
    assert mesh.all_sum(x, None) is x and mesh.all_max(x, None) is x
    assert mesh.batch_rows(None, 8) is None and mesh.world_size(None) == 1
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    opt = torch.optim.SGD([p], lr=0.1)
    mesh.all_reduce_grads(None, opt)
    t = torch.arange(4.0)
    mesh.broadcast_tensors(None, [t])
    assert torch.equal(p.grad, torch.full((2,), 3.0)) and torch.equal(t, torch.arange(4.0))


def test_initialize_refuses_before_joining():
    with pytest.raises(ValueError, match="needs --num_processes"):
        multihost.initialize("127.0.0.1:1", None, 0, "cpu")
    with pytest.raises(ValueError, match="need --coordinator"):
        multihost.initialize(None, 2, None, "cpu")
    args = argparse.Namespace(multihost=False, coordinator=None, num_processes=None,
                              process_id=1)
    with pytest.raises(ValueError, match="need --coordinator"):
        with multihost.maybe_initialize_from_args(args, "cpu"):
            pass
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.initialize("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_local_batch_rows_are_contiguous_blocks():
    assert [list(local_batch_rows(4, r, 8)) for r in range(4)] == [[0, 1], [2, 3], [4, 5],
                                                                  [6, 7]]
    assert list(local_batch_rows(1, 0, 3)) == [0, 1, 2]
    rows = np.concatenate([local_batch_rows(3, r, 12) for r in range(3)])
    np.testing.assert_array_equal(rows, np.arange(12))
    with pytest.raises(ValueError, match="not divisible by the 3 ranks"):
        local_batch_rows(3, 0, 8)


def _zipped(n=6):
    cfg = DataConfig(train_img_shape=(32, 24), input_ch=6, max_samples=n)
    return ZipDataset(get_dataset("synthetic", cfg, "train"),
                      get_dataset("synthetic_shifted", cfg, "train"))


class _Counting:
    """A dataset whose ``get_batch`` counts the samples it decodes."""

    def __init__(self, inner):
        self.inner, self.decoded = inner, 0

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, i):
        return self.inner[i]

    def get_batch(self, idx):
        self.decoded += len(idx)
        return self.inner.get_batch(idx)


def test_batch_iterator_decodes_exactly_the_local_rows():
    cfg = DataConfig(train_img_shape=(32, 24), input_ch=6, max_samples=6)
    full = list(batch_iterator(get_dataset("synthetic", cfg, "train"), 4, seed=3, epochs=2))
    for rank in range(2):
        ds = _Counting(get_dataset("synthetic", cfg, "train"))
        rows = local_batch_rows(2, rank, 4)
        got = list(batch_iterator(ds, 4, seed=3, epochs=2, local_rows=rows))
        assert ds.decoded == 2 * len(got) == 2 * len(full) == 4  # 2 epochs of 1 batch
        for g, f in zip(got, full):
            assert set(g) == set(f)
            for k in f:
                np.testing.assert_array_equal(g[k], f[k][rows], err_msg=k)
    with pytest.raises(ValueError, match="drop_last"):
        next(batch_iterator(ds, 4, drop_last=False, local_rows=rows))


def test_device_corpus_gathers_the_local_rows():
    zipped = _zipped()
    full = list(corpus_stream(zipped, CPU, 4, seed=1, epochs=2))
    rows = local_batch_rows(2, 1, 4)
    got = list(corpus_stream(zipped, CPU, 4, seed=1, epochs=2, local_rows=rows))
    assert len(got) == len(full) == 2
    for (gs, gt), (fs, ft) in zip(got, full):
        for g, f in ((gs, fs), (gt, ft)):
            for k in f:
                assert torch.equal(g[k], f[k][torch.from_numpy(rows)]), k


def test_augment_draws_are_the_rows_of_the_global_draws():
    cfg = ExperimentConfig(data=DataConfig(train_img_shape=(32, 24), input_ch=6))
    pre, target = pre_crop_canvas(cfg.data)
    whole = loops._draws(loops.augment_generator(0, 5), 4, pre, target, cfg, None)
    parts = [loops._draws(loops.augment_generator(0, 5), 2, pre, target, cfg, _rank(r))
             for r in range(2)]
    for i in range(3):
        assert torch.equal(torch.cat([p[i] for p in parts]), whole[i])
    assert whole[0].abs().sum() > 0 and 0 < int(whole[2].sum()) < 4  # crops and mixed flips


def test_seeded_dropout_masks_are_the_rows_of_the_global_masks():
    whole = SeededMasks(7, CPU)
    parts = [SeededMasks(7, CPU, data_parallel=_rank(r)) for r in range(2)]
    for step in (0, 3):
        for m in [whole, *parts]:
            m.reseed(step)
        for _ in range(2):  # the generator advances in call order
            want = whole((4, 3, 2, 2), CPU)
            got = torch.cat([p((2, 3, 2, 2), CPU) for p in parts])
            assert torch.equal(got, want)


def test_evaluate_refuses_what_a_group_cannot_do(tmp_path):
    cfg = ExperimentConfig(model=ModelConfig(net="drn_d_14", input_ch=6, n_class=8))
    with pytest.raises(ValueError, match="not both"):
        evaluate({}, cfg, dp=_rank(0), devices=["cpu"])
    with pytest.raises(ValueError, match="cannot be written by a data-parallel group"):
        evaluate({}, cfg, dp=_rank(0), save_dir=str(tmp_path / "dumps"))
    assert not (tmp_path / "dumps").exists()
