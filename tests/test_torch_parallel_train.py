"""MCD training and evaluation over a data-parallel group: 2 gloo ranks (one
spawn for the module) against 1 process against the JAX package's
``train_adapt(cfg, mesh=make_mesh(2))`` and ``evaluate(mesh=make_mesh(2))``
on the conftest's virtual CPU devices, float64 on every side.

drn_d_14, input_ch 6, 40 classes, ``convt`` heads, SGD (momentum 0.9,
weight decay 1e-3), the poly lr over 8 steps, ``num_k`` 2, global batch 4
of ``synthetic`` -> ``synthetic_shifted`` decoded at 32x24, 3 iterations
from the host pipeline (the ranks decode their own rows, ``local_rows``,
and cut their rows of the global crop and flip draws); 8 samples make 2
iterations an epoch, so ``ep1`` is written after the second. Every run
starts from one state, written by the port as a JAX ``.msgpack`` and
resumed by all. JAX's loop trains on the batches the port's 1-process
loop preprocessed (``jax_loops_fed``): the port's preprocess is float32,
JAX's float64.

Bound: parameters, BN statistics, both optimizers' momentum and the step
of each rank within 1e-9 of the 1-process run and of JAX's, relative to
each tensor's largest magnitude, and the logged losses within rtol 1e-9
(the float64 runs differ in summation order only). The ranks' replicas
are bit-equal to each other. The tester's confusion matrix of the
1-process run's weights, under 2 ranks and on two devices of one process,
with a tail batch that needs padding, is bit-equal to one device's and to
JAX's. The ranks run in the background while JAX trains.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import (
    Ranks, assert_states_close, logged, state_tensors, without_batch_counts)
from _torch_parity import jax_loops_fed, recording_train_inputs, x64
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu.parallel.mesh import make_mesh
from mcseg_tpu.train.loops import train_adapt as jax_train_adapt
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.train import loops
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, save_jax_checkpoint
from mcseg_tpu_torch.utils.jax_weights import params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, ITERATIONS, SEED = 4, 3, 3
REL = 1e-9
LOSSES = ("loss_source", "loss_b", "loss_dis", "lr")
VAL_SAMPLES = 5  # batch 4: a tail batch of one real sample and three pads
CLI_ARGV = ("synthetic synthetic_shifted --net drn_d_14 --dtype float32 --batch_size 2 "
            "--train_img_shape 32 24 --max_samples 2 --epochs 1 --num_k 1 --log_every 1 "
            "--num_workers 0").split()


def _config(out_dir, resume=""):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_14", input_ch=6, n_class=40, dtype="float64",
                          upsample="convt"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=B, train_img_shape=(32, 24), test_img_shape=(32, 24),
                        input_ch=6, max_samples=8, num_workers=0, device_corpus="off"),
        train=TrainConfig(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2,
                          d_loss="diff", lr_schedule="poly", lr_power=0.9, max_steps=8,
                          epochs=2, log_every=1, seed=SEED, out_dir=str(out_dir),
                          resume=resume))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    init = str(tmp / "init")
    cfg0 = _config(tmp / "unused")
    state = create_train_state(cfg0.model, cfg0.train, SEED, "cpu")
    save_jax_checkpoint(init, state, cfg0)
    cfg = _config(tmp / "one", resume=init)
    with recording_train_inputs(loops) as recorded:
        one = loops.train_adapt(cfg, max_iterations=ITERATIONS, device="cpu")
    assert len(recorded) == 2 * ITERATIONS
    params = one.params()  # what every evaluation scores

    val_cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data,
                                                                max_samples=VAL_SAMPLES))
    ranks = Ranks([  # in the background while JAX runs
        ("train", dict(cfg_dict=cfg.to_dict(), out_dir=str(tmp / "ranks"), kind="adapt",
                       iterations=ITERATIONS)),
        ("eval", dict(params=params, cfg_dict=cfg.to_dict(), max_samples=VAL_SAMPLES)),
        ("cli", dict(argv=CLI_ARGV, out_dir=str(tmp / "cli"))),
    ])
    with x64():
        with jax_loops_fed(recorded):
            jcfg = JaxExperimentConfig.from_dict(
                dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, out_dir=str(tmp / "jax"))).to_dict())
            jax_train_adapt(jcfg, mesh=make_mesh(2), max_iterations=ITERATIONS)
        _, jax_hist, _ = jax_evaluate(jax.tree.map(jnp.asarray, params_to_jax(params)),
                                      JaxExperimentConfig.from_dict(val_cfg.to_dict()),
                                      print_table=False, mesh=make_mesh(2), num_workers=0)
    jax_state, _ = load_checkpoint(str(tmp / "jax" / "last"), "cpu")
    return {"tmp": tmp, "cfg": cfg, "val_cfg": val_cfg, "one": one, "ranks": ranks.results(),
            "jax_state": jax_state, "params": params, "jax_hist": np.asarray(jax_hist, np.int64)}


def test_two_ranks_equal_one_rank(runs):
    want = state_tensors(runs["one"])
    assert runs["one"].step == ITERATIONS
    for rank, (train, _, _) in enumerate(runs["ranks"]):
        assert train["step"] == ITERATIONS
        assert_states_close(train["tensors"], want, f"rank {rank} vs 1 rank")
    # the replicas never drift apart: the same reduced values on every rank
    r0, r1 = (r[0]["tensors"] for r in runs["ranks"])
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    tmp = runs["tmp"]
    np.testing.assert_allclose(logged(tmp / "ranks" / "rank0", LOSSES),
                               logged(tmp / "one", LOSSES), rtol=REL, atol=0)


def test_two_ranks_and_one_rank_equal_jax_mesh(runs):
    want = without_batch_counts(state_tensors(runs["jax_state"]))
    assert runs["jax_state"].step == ITERATIONS
    assert_states_close(without_batch_counts(state_tensors(runs["one"])), want, "1 rank vs JAX")
    assert_states_close(without_batch_counts(runs["ranks"][0][0]["tensors"]), want,
                        "2 ranks vs JAX")
    tmp = runs["tmp"]
    want = logged(tmp / "jax", LOSSES)
    assert want.shape == (ITERATIONS, len(LOSSES))
    np.testing.assert_allclose(logged(tmp / "ranks" / "rank0", LOSSES), want, rtol=REL, atol=0)


def test_rank0_alone_writes_the_run_directory(runs):
    (train0, _, cli0), (train1, _, cli1) = runs["ranks"]
    assert train0["wrote"] == sorted(["train_log.jsonl", "ep1.pt", "ep1.config.json",
                                      "last.pt", "last.config.json"])
    assert train1["wrote"] is None
    assert cli0["wrote"] == sorted(["args.json", "train_log.jsonl", "ep1.pt",
                                    "ep1.config.json", "last.pt", "last.config.json"])
    assert cli1["wrote"] is None
    assert cli0["step"] == cli1["step"] == 1
    assert all(torch.equal(cli0["tensors"][k], cli1["tensors"][k]) for k in cli0["tensors"])
    assert len(logged(runs["tmp"] / "cli" / "rank0", ("loss_source",))) == 1


def test_eval_hist_over_ranks_and_devices_is_bit_equal(runs):
    """The padded tail batch leaves rank 0 one real row and rank 1 none."""
    params, val_cfg = runs["params"], runs["val_cfg"]
    _, single, _ = evaluate(params, val_cfg, print_table=False, device="cpu", num_workers=0)
    _, devices, _ = evaluate(params, val_cfg, print_table=False, num_workers=0,
                             devices=["cpu", "cpu"])
    four = dataclasses.replace(val_cfg, data=dataclasses.replace(val_cfg.data, max_samples=4))
    _, first_batch, _ = evaluate(params, four, print_table=False, device="cpu", num_workers=0)
    assert 0 < first_batch.sum() < single.sum()  # the tail's real sample is scored
    np.testing.assert_array_equal(single, runs["jax_hist"])
    np.testing.assert_array_equal(devices, single)
    for _, ev, _ in runs["ranks"]:
        np.testing.assert_array_equal(ev["hist"], single)
