"""Spatial partitioning through the trainers: 2 gloo CPU ranks (one spawn
for the module) in one data block of 2 row blocks against 1 process,
float64.

``adapt_train.main`` with ``--spatial_devices 2`` and the group flags
(``--coordinator``): drn_d_22, RGB+HHA (``--input_ch 6``: every rank
encodes the block's whole depth maps), ``convt`` heads, global batch 2 of
``synthetic`` -> ``synthetic_shifted`` at 16x32 (W x H), ``num_k`` 1, 2
iterations, the epoch-end scoring hook on (it scores whole images across
the data blocks); float64 through ``float64_commands`` (``--dtype`` offers
bfloat16 and float32 only). The multitask trainer (``train_multitask``,
MCD with the depth and boundary heads, ``resize`` upsampling) on the same
shapes for 1 iteration: the boundary targets come from whole labels, so
the rows beside the blocks' boundary keep theirs. The other two trunks
through ``adapt_train.main --spatial_devices 2``: ``fcn8s_vgg16`` at 32x64
(W x H: one row per block at /32, so ``conv6``'s halo of 3 spans the
neighbour's block and the image edge; the ranks draw their share of one
process's dropout masks) at global batch 2, and ``psp`` at 48x32 (h=4,
w=6 at /8: pyramid bins 1 and 2 average exactly, 3 and 6 resize first, 3
shrinking its rows and 6 stretching them) at global batch 4, RGB, ``num_k``
1, 1 iteration, without checkpoint files (``no_checkpoints``: FCN8s's
float64 state is 2 GB), each held to one process by rank 0, which runs
the command again alone after the job and sends only the differences;
rank 1 sends a digest of its state. At batch
2 the 1-bin branch's BN normalizes two nearly equal values per channel and
its gradient is cancellation noise (``tests/test_torch_vgg_psp_train.py``):
there one process as a group of one, whose BN sums in another order,
already differs from one process by 1.5e-8, and 2 ranks by 4.9e-9; at
batch 4 both differ by 5.5e-12. The 1-process runs use the ranks' two CPU
threads.

Bound: parameters, BN statistics, both optimizers' momentum and the step
within 1e-9 of the 1-process run, relative to each tensor's largest
magnitude; logged losses within rtol 1e-9, the logged val mIoU equal. Rank
0 alone writes the run directory, and the replicas are bit-equal.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parallel_worker import Ranks, assert_states_close, float64_commands, state_tensors
from mcseg_tpu_torch.cli import adapt_train
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.train.loops import train_multitask
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

REL = 1e-9
HEADS = dict(depth_weight=0.5, boundary_weight=1.0)
CLI_ARGV = ("synthetic synthetic_shifted --net drn_d_22 --input_ch 6 --batch_size 2 "
            "--train_img_shape 16 32 --max_samples 4 --epochs 1 --num_k 1 --lr 0.05 "
            "--lr_schedule constant --log_every 1 --num_workers 0 --eval_every_epochs 1 "
            "--seed 2").split()
ADAPT_LOSSES = ("loss_source", "loss_b", "loss_dis", "lr")
MT_LOSSES = ("loss_source", "loss_seg", "loss_depth", "loss_boundary", "loss_b", "loss_dis")
TRUNKS = {"fcn8s_vgg16": (32, 64, 2), "psp": (48, 32, 4)}  # --train_img_shape W H, batch


def _trunk_argv(net):
    w, h, b = TRUNKS[net]
    return (f"synthetic synthetic_shifted --net {net} --batch_size {b} --train_img_shape {w} {h} "
            f"--max_samples {b} --epochs 1 --num_k 1 --lr 0.05 --lr_schedule constant "
            f"--log_every 1 --num_workers 0 --seed 4").split()


def _mt_config(out_dir):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=6, n_class=40, dtype="float64",
                          upsample="resize"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=2, train_img_shape=(16, 32), test_img_shape=(16, 32),
                        input_ch=6, max_samples=4, num_workers=0),
        train=TrainConfig(lr=0.05, num_k=1, lr_schedule="constant", epochs=1, log_every=1,
                          seed=3, out_dir=str(out_dir)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_cli")
    ranks = Ranks([  # in the background while the 1-process runs train
        ("cli", dict(argv=CLI_ARGV, out_dir=str(tmp / "cli"), float64=True, spatial=2)),
        ("train", dict(cfg_dict=_mt_config(tmp / "unused").to_dict(), out_dir=str(tmp / "mt"),
                       kind="multitask", iterations=1, space=2, **HEADS)),
    ] + [("cli", dict(argv=_trunk_argv(net), out_dir=str(tmp / net), float64=True, spatial=2,
                      lean=True)) for net in TRUNKS])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with float64_commands():
            one = adapt_train.main(CLI_ARGV + ["--out_dir", str(tmp / "one")], device="cpu")
        mt_one = train_multitask(_mt_config(tmp / "mt_one"), max_iterations=1, device="cpu",
                                 **HEADS)
    finally:
        torch.set_num_threads(threads)
    return {"tmp": tmp, "one": one, "mt_one": mt_one, "ranks": ranks.results()}


def _log(run_dir, keys):
    """[records holding ``keys``, keys] of a run's training log."""
    with open(run_dir / "train_log.jsonl") as f:
        records = [r for r in map(json.loads, f) if all(k in r for k in keys)]
    return np.array([[r[k] for k in keys] for r in records])


def test_adapt_train_command_with_spatial_devices_equals_one_process(runs):
    tmp, one = runs["tmp"], runs["one"]
    assert one.g.conv0.weight.dtype == torch.float64 and one.step == 2
    want = state_tensors(one)
    (cli0, *_), (cli1, *_) = runs["ranks"]
    for rank, cli in enumerate((cli0, cli1)):
        assert cli["step"] == 2
        assert_states_close(cli["tensors"], want, f"rank {rank} vs 1 process")
    assert all(torch.equal(cli0["tensors"][k], cli1["tensors"][k]) for k in want)
    assert cli1["wrote"] is None and "args.json" in cli0["wrote"]
    got = _log(tmp / "cli" / "rank0", ADAPT_LOSSES)
    assert got.shape == (2, len(ADAPT_LOSSES))
    np.testing.assert_allclose(got, _log(tmp / "one", ADAPT_LOSSES), rtol=REL, atol=0)
    miou = _log(tmp / "cli" / "rank0", ("val_miou",))
    assert miou.shape == (1, 1)
    np.testing.assert_array_equal(miou, _log(tmp / "one", ("val_miou",)))


def test_multitask_trainer_on_row_blocks_equals_one_process(runs):
    want = state_tensors(runs["mt_one"])
    for rank, (_, mt, *_) in enumerate(runs["ranks"]):
        assert mt["step"] == 1
        assert_states_close(mt["tensors"], want, f"multitask rank {rank} vs 1 process")
    got = _log(runs["tmp"] / "mt" / "rank0", MT_LOSSES)
    assert got.shape == (1, len(MT_LOSSES))
    np.testing.assert_allclose(got, _log(runs["tmp"] / "mt_one", MT_LOSSES), rtol=REL, atol=0)


@pytest.mark.parametrize("net", list(TRUNKS))
def test_fcn8s_and_psp_on_row_blocks_equal_one_process(runs, net):
    got = [r[2 + list(TRUNKS).index(net)] for r in runs["ranks"]]
    assert [g["step"] for g in got] == [1, 1] and got[0]["one_step"] == 1
    errors = got[0]["errors"]
    assert got[0]["float64"] and ("G.ppm.reduce_bn0.running_var" if net == "psp"
                                  else "G.conv6.weight") in errors
    for k, err in sorted(errors.items()):
        assert err <= REL, f"{net} rank 0 vs 1 process {k}: relative error {err:.3g}"
    assert got[0]["digest"] == got[1]["digest"]  # the replicas are bit-equal
    assert got[1]["wrote"] is None and "args.json" in got[0]["wrote"]
