"""Multitask MCD training over a data-parallel group: 2 gloo ranks (one
spawn) against 1 process against the JAX package's
``train_multitask(cfg, mesh=make_mesh(2))`` on the conftest's virtual CPU
devices, float64 on every side.

drn_d_14, input_ch 6, 40 classes, the depth head (berHu, weight 0.5) and
the boundary head (balanced BCE, weight 1.0), SGD, ``num_k`` 2, global
batch 4 of ``synthetic`` -> ``synthetic_shifted`` at 32x24, 2 iterations
fed from the card-resident corpus path (``--device_corpus on``: every rank
stages the corpus and gathers its rows). Every run resumes one state that
the port wrote as a JAX ``.msgpack``; JAX's loop trains on the batches the
port's 1-process loop preprocessed (``jax_loops_fed``). berHu's ``c`` is
the max over the global batch, and the boundary loss's class balance and
weight sum are global too.

Bound: parameters, BN statistics, both optimizers' momentum and the step
within 1e-9 of the 1-process run and of JAX's, relative to each tensor's
largest magnitude; logged losses within rtol 1e-9. The ranks run in the
background while JAX trains.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parallel_worker import (
    Ranks, assert_states_close, logged, state_tensors, without_batch_counts)
from _torch_parity import jax_loops_fed, recording_train_inputs, x64
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.parallel.mesh import make_mesh
from mcseg_tpu.train.loops import train_multitask as jax_train_multitask
from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.train import loops
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, save_jax_checkpoint
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, ITERATIONS, SEED = 4, 2, 5
REL = 1e-9
HEADS = dict(depth_weight=0.5, boundary_weight=1.0)
LOSSES = ("loss_source", "loss_seg", "loss_depth", "loss_boundary", "loss_b", "loss_dis", "lr")


def _config(out_dir, resume=""):
    return ExperimentConfig(
        model=ModelConfig(net="drn_d_14", input_ch=6, n_class=40, dtype="float64",
                          upsample="convt"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                        batch_size=B, train_img_shape=(32, 24), test_img_shape=(32, 24),
                        input_ch=6, max_samples=8, num_workers=0, device_corpus="on"),
        train=TrainConfig(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2,
                          d_loss="diff", lr_schedule="poly", lr_power=0.9, max_steps=8,
                          epochs=1, log_every=1, seed=SEED, out_dir=str(out_dir),
                          resume=resume))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_multitask")
    init = str(tmp / "init")
    cfg0 = _config(tmp / "unused")
    state = create_train_state(cfg0.model, cfg0.train, SEED, "cpu", aux_heads=("D", "B"))
    save_jax_checkpoint(init, state, cfg0)
    cfg = _config(tmp / "one", resume=init)
    with recording_train_inputs(loops) as recorded:
        one = loops.train_multitask(cfg, max_iterations=ITERATIONS, device="cpu", **HEADS)
    assert len(recorded) == 2 * ITERATIONS and len(recorded[0]) == 3  # with depth

    ranks = Ranks([("train", dict(cfg_dict=cfg.to_dict(), out_dir=str(tmp / "ranks"),
                                  kind="multitask", iterations=ITERATIONS, **HEADS))])

    with x64(), jax_loops_fed(recorded):
        jcfg = JaxExperimentConfig.from_dict(
            dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, out_dir=str(tmp / "jax"))).to_dict())
        jax_train_multitask(jcfg, mesh=make_mesh(2), max_iterations=ITERATIONS, **HEADS)
    jax_state, _ = load_checkpoint(str(tmp / "jax" / "last"), "cpu")
    return {"tmp": tmp, "one": one, "ranks": [r[0] for r in ranks.results()], "jax": jax_state}


def test_multitask_two_ranks_equal_one_rank(runs):
    want = state_tensors(runs["one"])
    assert runs["one"].step == ITERATIONS and runs["one"].b is not None
    for rank, train in enumerate(runs["ranks"]):
        assert train["step"] == ITERATIONS
        assert_states_close(train["tensors"], want, f"rank {rank} vs 1 rank", REL)
    r0, r1 = (r["tensors"] for r in runs["ranks"])
    assert all(torch.equal(r0[k], r1[k]) for k in r0)
    assert runs["ranks"][1]["wrote"] is None
    assert "last.pt" in runs["ranks"][0]["wrote"]
    np.testing.assert_allclose(logged(runs["tmp"] / "ranks" / "rank0", LOSSES),
                               logged(runs["tmp"] / "one", LOSSES), rtol=REL, atol=0)


def test_multitask_two_ranks_and_one_rank_equal_jax_mesh(runs):
    want = without_batch_counts(state_tensors(runs["jax"]))
    assert runs["jax"].step == ITERATIONS
    assert_states_close(without_batch_counts(state_tensors(runs["one"])), want,
                        "1 rank vs JAX", REL)
    assert_states_close(without_batch_counts(runs["ranks"][0]["tensors"]), want,
                        "2 ranks vs JAX", REL)
    want = logged(runs["tmp"] / "jax", LOSSES)
    assert want.shape == (ITERATIONS, len(LOSSES))
    np.testing.assert_allclose(logged(runs["tmp"] / "ranks" / "rank0", LOSSES), want,
                               rtol=REL, atol=0)
