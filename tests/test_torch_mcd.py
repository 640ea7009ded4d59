"""The port's MCD iteration against the JAX package's ``make_mcd_step``, in
float64 on both sides.

drn_d_14, input_ch 6, 5 classes, batch 2, 24x16, ``convt`` heads, SGD with
momentum 0.9 and weight decay 1e-3, the poly lr over 8 steps (so every
iteration runs at another lr), ``num_k`` 2. Both sides start from the same
JAX initialization (BN statistics and head biases randomized) carried over
by ``params_from_jax``; the port's state is compared in JAX's own tree
through ``params_to_jax``. One jitted JAX step serves every comparison.

Bound: every loss, parameter and BN running mean and variance within 1e-9
of the JAX value, relative to that leaf's largest magnitude (the JAX
package's own fp64 trajectory test allows 1e-6 over 30 steps). Measured:
1 iteration 1.2e-14, 5 iterations 4.6e-13 (both in the losses). The float64 step differs only in
summation order; a semantic slip (a missing BN advance, an lr off by one
step, an extra optimizer update) moves values by 1e-4 or more.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.ops.upsample import upsample_matmul
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.models.drn import build_drn
from mcseg_tpu_torch.ops.upsample import upsample_logits
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.jax_weights import (
    opt_state_from_jax, params_from_jax, params_to_jax)
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W, NC = 2, 24, 16, 5
REL = 1e-9
STEPS = 5


def _tcfg():
    return dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2,
                d_loss="diff", lr_schedule="poly", lr_power=0.9, max_steps=8)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xs = rng.randn(B, H, W, 6)
        ys = rng.randint(0, NC, (B, H, W))
        ys[0, :3] = 255  # ignored pixels on every step
        out.append((xs, ys, rng.randn(B, H, W, 6)))
    return out


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def jax_run():
    """Initial JAX params/stats and the JAX trajectory: after each
    iteration its metrics, params, G's batch_stats and both momentum
    traces."""
    mcfg = JaxModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64",
                          upsample="convt")
    params, stats = jax_params(mcfg, img_hw=(H, W), seed=4)
    params, stats = _tree_np(params), _tree_np(stats)
    batches = _batches(STEPS)
    tcfg = JaxTrainConfig(**_tcfg())
    traj = []
    with x64():
        tx_g = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        tx_f = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        p = jax.tree.map(jnp.asarray, params)
        state = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=jax.random.key(1))
        step = jax.jit(jax_make_mcd_step(*jax_get_models(mcfg), tx_g, tx_f, tcfg))
        for xs, ys, xt in batches:
            state, metrics = step(state, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
            traj.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _tree_np(state.params),
                "stats": _tree_np(state.batch_stats["G"]),
                "trace_g": _tree_np(state.opt_g.inner_state[1].trace),
                "trace_f": _tree_np(state.opt_f.inner_state[1].trace),
            })
    return {"params": params, "stats": stats, "batches": batches, "traj": traj}


def _port_state(params, stats):
    mcfg = ModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64",
                       upsample="convt")
    return create_train_state(mcfg, TrainConfig(**_tcfg()), device="cpu",
                              params=params_from_jax(params, stats))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _run_port(state, batches, uses_one_classifier=False):
    step = make_mcd_step(TrainConfig(**_tcfg()), uses_one_classifier, torch.float64)
    out = []
    for xs, ys, xt in batches:
        m = step(state, _nchw(xs), torch.from_numpy(ys), _nchw(xt))
        out.append({k: float(v) for k, v in m.items()})
    return out


def _max_rel_err(got_tree, want_tree):
    """Largest leaf error relative to the leaf's largest magnitude."""
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


def _check_against(state, metrics, ref):
    for k in ("loss_source", "loss_b", "loss_dis", "lr"):
        np.testing.assert_allclose(metrics[k], ref["metrics"][k], rtol=REL, atol=0, err_msg=k)
    p, s = params_to_jax(state.params())
    assert jax.tree.structure(p) == jax.tree.structure(ref["params"])
    assert _max_rel_err(p, ref["params"]) < REL
    assert set(s) == {"G", "F1", "F2"} and not s["F1"] and not s["F2"]
    assert _max_rel_err(s["G"], ref["stats"]) < REL  # mean and var


def test_one_iteration_matches_jax_fp64(jax_run):
    state = _port_state(jax_run["params"], jax_run["stats"])
    (metrics,) = _run_port(state, jax_run["batches"][:1])
    assert state.step == 1
    _check_against(state, metrics, jax_run["traj"][0])


def test_poly_lr_trajectory_matches_jax_fp64(jax_run):
    state = _port_state(jax_run["params"], jax_run["stats"])
    metrics = _run_port(state, jax_run["batches"])
    lrs = [m["lr"] for m in metrics]
    assert len(set(lrs)) == STEPS and lrs == sorted(lrs, reverse=True)
    for m, ref in zip(metrics, jax_run["traj"]):
        for k in ("loss_source", "loss_b", "loss_dis", "lr"):
            np.testing.assert_allclose(m[k], ref["metrics"][k], rtol=REL, atol=0, err_msg=k)
    _check_against(state, metrics[-1], jax_run["traj"][-1])


def test_momentum_carried_over_from_jax(jax_run):
    """Start the port from JAX's state after iteration 1 (weights, BN
    statistics and both optax momentum traces through
    ``opt_state_from_jax``); its iteration 2 matches JAX's."""
    ref1, ref2 = jax_run["traj"][:2]
    state = _port_state(ref1["params"], {"G": ref1["stats"], "F1": {}, "F2": {}})
    opt_state_from_jax(state.opt_g, {"G": state.g}, {"G": ref1["trace_g"]})
    opt_state_from_jax(state.opt_f, {"F1": state.f1, "F2": state.f2}, ref1["trace_f"])
    state.step = 1
    (metrics,) = _run_port(state, jax_run["batches"][1:2])
    _check_against(state, metrics, ref2)
    with pytest.raises(KeyError):
        opt_state_from_jax(state.opt_g, {"G": state.g}, {"G": ref1["trace_f"]["F1"]})


def test_weights_round_trip_through_jax_layout(jax_run):
    port = params_from_jax(jax_run["params"], jax_run["stats"])
    p, s = params_to_jax(port)
    assert _max_rel_err(p, jax_run["params"]) == 0.0
    assert _max_rel_err(s["G"], jax_run["stats"]["G"]) == 0.0
    back = params_from_jax(p, s)
    for name in port:
        assert port[name].keys() == back[name].keys()
        for k in port[name]:
            assert torch.equal(port[name][k], back[name][k]), (name, k)


def test_one_classifier_f2_drifts_only_by_weight_decay(jax_run):
    """``uses_one_classifier``: F1 stands in for F2, the discrepancy is 0,
    and F2 gets zero gradients, so per iteration its optimizer applies
    decay + momentum twice (steps A and B): buf = m*buf + wd*p; p -= lr*buf."""
    state = _port_state(jax_run["params"], jax_run["stats"])
    f2 = {k: v.numpy().copy() for k, v in state.params()["F2"].items()}
    f1_before = state.params()["F1"]["score.weight"].clone()
    metrics = _run_port(state, jax_run["batches"][:2], uses_one_classifier=True)
    cfg = TrainConfig(**_tcfg())
    buf = {k: np.zeros_like(v) for k, v in f2.items()}
    for m in metrics:
        assert m["loss_dis"] == 0.0
        for _ in range(2):
            for k in f2:
                buf[k] = cfg.momentum * buf[k] + cfg.weight_decay * f2[k]
                f2[k] = f2[k] - m["lr"] * buf[k]
    got = state.params()["F2"]
    for k in f2:
        np.testing.assert_allclose(got[k].numpy(), f2[k], rtol=1e-14, atol=0)
    assert not torch.equal(state.params()["F1"]["score.weight"], f1_before)


def test_train_mode_bn_update_matches_flax():
    """One train-mode forward: output and the new running mean and var
    against flax. Flax advances the variance with the biased batch
    variance; ``nn.BatchNorm2d`` would be off by n/(n-1) in the update."""
    jcfg = JaxModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64")
    params, stats = jax_params(jcfg, img_hw=(H, W), seed=6)
    params, stats = _tree_np(params), _tree_np(stats)
    x = np.random.RandomState(7).randn(B, H, W, 6)
    with x64():
        g, _, _ = jax_get_models(jcfg)
        want, mut = g.apply({"params": params["G"], "batch_stats": stats["G"]},
                            jnp.asarray(x), True, mutable=["batch_stats"])
        want, new_stats = np.asarray(want), _tree_np(mut["batch_stats"])
    ours = build_drn("drn_d_14", input_ch=6).double().train()
    ours.load_state_dict(params_from_jax(params, stats)["G"])
    plain = copy.deepcopy(ours)
    for m in plain.modules():  # the same BN with torch's update
        if isinstance(m, torch.nn.BatchNorm2d):
            m.__class__ = torch.nn.BatchNorm2d
    got = ours(_nchw(x))
    plain(_nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-10 * np.abs(want).max())
    _, s = params_to_jax({"G": ours.state_dict()})
    _, s_plain = params_to_jax({"G": plain.state_dict()})
    assert _max_rel_err(s["G"], new_stats) < 1e-12
    # the unbiased update is measurably off (most where n = B*h*w is small)
    assert _max_rel_err(s_plain["G"], new_stats) > 1e-3


@pytest.mark.parametrize("mode", ["convt", "resize"])
def test_upsample_input_gradients_match_jax_vjp(mode):
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 2, 4)  # NHWC logits at stride 8
    cot = rng.randn(2, 24, 16, 4)
    with x64():
        _, vjp = jax.vjp(lambda a: upsample_matmul(a, 24, 16, mode), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(cot))
    t = _nchw(x).requires_grad_(True)
    upsample_logits(t, 8, mode).backward(_nchw(cot))
    np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-12)


def test_config_copy_matches():
    """The fp64 port step runs the JAX TrainConfig's fields unchanged."""
    assert dataclasses.asdict(TrainConfig(**_tcfg())) == dataclasses.asdict(
        JaxTrainConfig(**_tcfg()))
