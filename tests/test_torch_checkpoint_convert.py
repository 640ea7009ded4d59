"""JAX msgpack checkpoints both ways (``utils/checkpoint.py``
``save_jax_checkpoint`` / ``load_jax_checkpoint``, and ``load_checkpoint``
/ ``load_params`` reading a ``.msgpack`` where no ``.pt`` is).

The MCD case runs in float64 on both sides: drn_d_14, input_ch 6, 5
classes, batch 2, 24x16, SGD (momentum 0.9, weight decay 1e-3), the poly
lr over 8 steps, ``num_k`` 2. JAX takes one iteration from a state whose rng
is the one its loop builds (``create_train_state(key(seed))``; BN
statistics randomized) and writes it with its own ``save_checkpoint``.

  * The port reads it: weights, BN statistics, both momentum traces and
    the step equal JAX's bit for bit.
  * The port resumes from it: its next iteration matches JAX's within
    1e-9, relative to each leaf's largest magnitude (the bound of
    ``tests/test_torch_mcd.py``).
  * The port writes it back with ``save_jax_checkpoint``: JAX's
    ``load_checkpoint`` restores every leaf of JAX's own checkpoint bit
    for bit (``count``, ``learning_rate`` and ``rng`` derived from the
    step and the config), and JAX's next iteration from either checkpoint
    is the same, bit for bit.

The multitask case (depth and boundary heads, Adam, float32) goes the
other way round: a port state after one iteration, written by
``save_jax_checkpoint``, is restored by JAX's ``load_checkpoint`` with
every leaf equal (the rng as ``init_multitask_state`` and one step
split it), and a
``.msgpack`` that JAX writes from that state reads back into the port's
state exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_params_jax_layout, x64
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu.utils import checkpoint as jax_ckpt
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.multitask import make_multitask_mcd_step
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import (
    load_checkpoint, load_jax_checkpoint, load_params, save_jax_checkpoint)
from mcseg_tpu_torch.utils.jax_weights import opt_state_to_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W, NC = 2, 24, 16, 5
REL = 1e-9
SEED = 3


def _config(dtype="float64", **train):
    tcfg = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2, d_loss="diff",
                lr_schedule="poly", lr_power=0.9, max_steps=8, seed=SEED)
    tcfg.update(train)
    return JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype=dtype,
                             upsample="convt"),
        train=JaxTrainConfig(**tcfg))


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ys = rng.randint(0, NC, (B, H, W))
        ys[0, :3] = 255
        out.append((rng.randn(B, H, W, 6), ys, rng.randn(B, H, W, 6)))
    return out


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_bit_equal(got, want, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")


def _max_rel_err(got_tree, want_tree):
    errs = jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                                           / max(np.abs(np.asarray(b)).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


@pytest.fixture(scope="module")
def jax_mcd(tmp_path_factory):
    """JAX's checkpoint after one float64 MCD iteration, and JAX's second
    iteration from it (metrics and state)."""
    tmp = tmp_path_factory.mktemp("jax_mcd")
    cfg = _config()
    params, stats = port_params_jax_layout(cfg.model, img_hw=(H, W), seed=SEED)
    batches = _batches(2)
    with x64():
        tx_g = jax_get_optimizer("sgd", cfg.train.lr, cfg.train.momentum, cfg.train.weight_decay)
        tx_f = jax_get_optimizer("sgd", cfg.train.lr, cfg.train.momentum, cfg.train.weight_decay)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        # the rng as JAX's create_train_state(key(seed)) leaves it
        state = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), stats["G"]),
                         "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=jax.random.split(jax.random.key(cfg.train.seed))[1])
        step = jax.jit(jax_make_mcd_step(*jax_get_models(cfg.model), tx_g, tx_f, cfg.train))
        # every step starts from a restored state, so one compile serves all
        jax_ckpt.save_checkpoint(str(tmp / "jax" / "ep0"), state, cfg)
        state0, _ = jax_ckpt.load_checkpoint(str(tmp / "jax" / "ep0"))
        xs, ys, xt = batches[0]
        state1, _ = step(state0, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
        prefix = str(tmp / "jax" / "ep1")
        jax_ckpt.save_checkpoint(prefix, state1, cfg)
        state1, _ = jax_ckpt.load_checkpoint(prefix)
        xs, ys, xt = batches[1]
        state2, metrics2 = step(state1, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
        yield {"prefix": prefix, "tmp": tmp, "batches": batches, "step": step,
               "state1": jax.device_get(state1), "state2": jax.device_get(state2),
               "metrics2": {k: float(v) for k, v in metrics2.items()}}


def _port_opt_trees(state):
    heads = {k: m for k, m in state.modules().items() if k != "G"}
    return opt_state_to_jax(state.opt_g, {"G": state.g}), opt_state_to_jax(state.opt_f, heads)


def test_port_reads_jax_mcd_checkpoint_bit_for_bit(jax_mcd):
    prefix = jax_mcd["prefix"]
    assert not os.path.exists(prefix + ".pt")
    state, cfg = load_checkpoint(prefix, device="cpu")
    ref = jax_mcd["state1"]
    assert state.step == 1 and cfg.train.num_k == 2
    p, s = params_to_jax(state.params())
    _assert_bit_equal(p, _np(ref.params), "params")
    _assert_bit_equal({"G": s["G"]}, {"G": _np(ref.batch_stats["G"])}, "batch_stats")
    g, f = _port_opt_trees(state)
    _assert_bit_equal(g["trace"], {"G": _np(ref.opt_g.inner_state[1].trace)}, "trace G")
    _assert_bit_equal(f["trace"], _np(ref.opt_f.inner_state[1].trace), "trace F")
    assert float(np.abs(np.asarray(ref.opt_g.inner_state[1].trace["conv0"]["kernel"])).max()) > 0
    params, _ = load_params(prefix)  # what the tester scores
    for name in ("G", "F1", "F2"):
        for k, v in state.modules()[name].state_dict().items():
            assert torch.equal(params[name][k], v), (name, k)


def test_port_resumes_jax_checkpoint_fp64(jax_mcd):
    state, cfg = load_checkpoint(jax_mcd["prefix"], device="cpu")
    step = make_mcd_step(cfg.train, dtype=torch.float64)
    xs, ys, xt = jax_mcd["batches"][1]
    metrics = step(state, _nchw(xs), torch.from_numpy(ys), _nchw(xt))
    for k in ("loss_source", "loss_b", "loss_dis", "lr"):
        np.testing.assert_allclose(float(metrics[k]), jax_mcd["metrics2"][k], rtol=REL, atol=0,
                                   err_msg=k)
    ref = jax_mcd["state2"]
    p, s = params_to_jax(state.params())
    assert _max_rel_err(p, _np(ref.params)) < REL
    assert _max_rel_err(s["G"], _np(ref.batch_stats["G"])) < REL
    g, f = _port_opt_trees(state)
    assert _max_rel_err(g["trace"]["G"], _np(ref.opt_g.inner_state[1].trace)) < REL
    assert _max_rel_err(f["trace"], _np(ref.opt_f.inner_state[1].trace)) < REL


def test_jax_resumes_port_written_checkpoint_as_its_own(jax_mcd):
    state, cfg = load_checkpoint(jax_mcd["prefix"], device="cpu")
    prefix = str(jax_mcd["tmp"] / "port" / "ep1")
    assert save_jax_checkpoint(prefix, state, cfg) == prefix + ".msgpack"
    with x64():
        own, own_cfg = jax_ckpt.load_checkpoint(jax_mcd["prefix"])
        conv, conv_cfg = jax_ckpt.load_checkpoint(prefix)
        assert conv_cfg == own_cfg
        _assert_bit_equal(_np(jax_ckpt._state_to_dict(conv)),
                          _np(jax_ckpt._state_to_dict(own)), "restored state")
        xs, ys, xt = (jnp.asarray(a) for a in jax_mcd["batches"][1])
        nxt_own, m_own = jax_mcd["step"](own, xs, ys, xt)
        nxt_conv, m_conv = jax_mcd["step"](conv, xs, ys, xt)
        _assert_bit_equal(_np(jax_ckpt._state_to_dict(nxt_conv)),
                          _np(jax_ckpt._state_to_dict(nxt_own)), "next state")
        _assert_bit_equal(_np(m_conv), _np(m_own), "next metrics")
    assert int(conv.opt_g.count) == 1 + cfg.train.num_k and int(conv.opt_f.count) == 2


MT_TRAIN = dict(opt="adam", lr=1e-3, weight_decay=1e-4, num_k=2, lr_schedule="poly",
                max_steps=8, seed=SEED)


def test_multitask_adam_both_ways(tmp_path):
    jcfg = _config("float32", **MT_TRAIN)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, input_ch=3))
    cfg = ExperimentConfig.from_dict(jcfg.to_dict())
    state = create_train_state(cfg.model, cfg.train, cfg.train.seed, "cpu", aux_heads=("D", "B"))
    rng = np.random.RandomState(1)
    xs = torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32))
    xt = torch.from_numpy(rng.randn(B, 3, H, W).astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, NC, (B, H, W)))
    ds = torch.from_numpy(rng.uniform(0.5, 5.0, (B, H, W)).astype(np.float32))
    make_multitask_mcd_step(cfg.train, boundary_weight=1.0)(state, xs, ys, ds, xt)
    port_p, port_s = params_to_jax(state.params())
    port_g, port_f = _port_opt_trees(state)

    prefix = str(tmp_path / "port" / "last")
    save_jax_checkpoint(prefix, state, cfg)
    restored, _ = jax_ckpt.load_checkpoint(prefix)
    assert set(restored.params) == {"G", "F1", "F2", "D", "B"}
    _assert_bit_equal(_np(restored.params), port_p, "params")
    _assert_bit_equal(_np(restored.batch_stats), {k: port_s[k] for k in ("G", "F1", "F2")},
                      "batch_stats")
    per_g = 1 + cfg.train.num_k
    port_g = {k: v if k == "count" else v["G"] for k, v in port_g.items()}
    for opt, want, count in ((restored.opt_g, port_g, per_g), (restored.opt_f, port_f, 2)):
        adam = opt.inner_state[1]
        assert int(adam.count) == int(want["count"]) == count == int(opt.count)
        _assert_bit_equal(_np(adam.mu), want["mu"], "mu")
        _assert_bit_equal(_np(adam.nu), want["nu"], "nu")
    assert int(restored.step) == 1
    for opt in (restored.opt_g, restored.opt_f):  # the rate of iteration 0
        assert np.asarray(opt.hyperparams["learning_rate"]) == np.float32(cfg.train.lr)
    # init_multitask_state keeps the 4th of 4 keys, an MCD step the 1st of 5
    mt_rng = jax.random.split(jax.random.key(SEED), 4)[3]
    want_rng = jax.random.key_data(jax.random.split(mt_rng, 5)[0])
    np.testing.assert_array_equal(jax.random.key_data(restored.rng), want_rng)

    # JAX writes the restored state; the port reads back its own state
    jax_prefix = str(tmp_path / "jax" / "last")
    jax_ckpt.save_checkpoint(jax_prefix, restored, jcfg)
    back, _ = load_jax_checkpoint(jax_prefix, device="cpu")
    assert back.step == 1 and set(back.modules()) == {"G", "F1", "F2", "D", "B"}
    for name, m in state.modules().items():
        for k, v in m.state_dict().items():
            if not k.endswith("num_batches_tracked"):  # flax keeps no such counter
                assert torch.equal(back.modules()[name].state_dict()[k], v), (name, k)
    for got_opt, want_opt in ((back.opt_g, state.opt_g), (back.opt_f, state.opt_f)):
        got, want = got_opt.state_dict()["state"], want_opt.state_dict()["state"]
        assert got.keys() == want.keys()
        for i in want:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(got[i][k], want[i][k]), (i, k)
