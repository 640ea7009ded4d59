"""The port's late (score) fusion against the JAX package's
``models/fusion.py``, in float64 on both sides.

drn_d_14 trunks, input_ch 6 (channels 0:3 to the RGB trunk, 3:6 to the HHA
trunk), 5 classes, batch 2, 24x16, ``convt`` heads. The weights are seeded
in the JAX layout with the tree of JAX's initializer
(``_torch_parity.port_params_jax_layout``) and carried into the port by
``params_from_jax``.

Bounds, all relative to the largest value of the compared quantity:
G's two feature maps and F's summed logits 1e-9; one MCD iteration
against ``make_mcd_step`` (losses, every parameter of both trunks and all
four heads, G's BN statistics) 1e-9, as ``tests/test_torch_mcd.py``; the
tester's averaged late-fusion head against JAX's two-apply mean 1e-12 (the
two differ by one rounding of the averaged parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_params_jax_layout, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.eval.tester import _averaged_head_params
from mcseg_tpu_torch.models.factory import get_models
from mcseg_tpu_torch.models.fusion import LateFusionClassifier, LateFusionGenerator
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W, NC = 2, 24, 16, 5
REL = 1e-9
TCFG = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2,
            d_loss="diff", lr_schedule="poly", lr_power=0.9, max_steps=8)
MCFG = dict(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64", upsample="convt",
            fusion="late")


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _max_rel_err(got_tree, want_tree):
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


@pytest.fixture(scope="module")
def weights():
    params, stats = port_params_jax_layout(JaxModelConfig(**MCFG), img_hw=(H, W), seed=12)
    return _tree_np(params), _tree_np(stats)


def test_late_fusion_factory_and_names():
    g, f1, f2 = get_models(ModelConfig(**MCFG))
    assert isinstance(g, LateFusionGenerator) and isinstance(f1, LateFusionClassifier)
    assert {k.split(".")[0] for k in g.state_dict()} == {"rgb_trunk", "hha_trunk"}
    assert {k.split(".")[0] for k in f2.state_dict()} == {"rgb_head", "hha_head"}
    assert g.rgb_trunk.conv0.in_channels == g.hha_trunk.conv0.in_channels == 3
    with pytest.raises(ValueError, match="--fusion late requires --input_ch 6"):
        get_models(ModelConfig(**{**MCFG, "input_ch": 4}))


def test_late_fusion_forward_matches_jax_fp64(weights):
    params, stats = weights
    x = np.random.RandomState(13).randn(B, H, W, 6)
    jcfg = JaxModelConfig(**MCFG)
    with x64():
        g, f1, _ = jax_get_models(jcfg)
        feats = g.apply({"params": params["G"], "batch_stats": stats["G"]}, jnp.asarray(x), False)
        want_feats = [np.asarray(f) for f in feats]
        want_logits = np.asarray(f1.apply({"params": params["F1"]}, feats, False))
    tg, tf1, _ = (m.double().eval() for m in get_models(ModelConfig(**MCFG)))
    carried = params_from_jax(params, stats)
    tg.load_state_dict(carried["G"])
    tf1.load_state_dict(carried["F1"])
    with torch.no_grad():
        got_feats = tg(_nchw(x))
        got_logits = tf1(got_feats)
    assert isinstance(got_feats, tuple) and len(got_feats) == 2
    for got, want in zip(got_feats, want_feats):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                                   atol=REL * np.abs(want).max())
    np.testing.assert_allclose(got_logits.permute(0, 2, 3, 1).numpy(), want_logits, rtol=0,
                               atol=REL * np.abs(want_logits).max())


def test_averaged_late_fusion_head_equals_jax_two_apply_mean(weights):
    """The tester averages F1 and F2 in parameter space; for late fusion
    the JAX tester applies both heads and averages the logits. Every op of
    the head is linear in its parameters, so the two are one function."""
    params, stats = weights
    rng = np.random.RandomState(14)
    feats = (rng.randn(B, 3, 2, 512), rng.randn(B, 3, 2, 512))
    with x64():
        _, f1, f2 = jax_get_models(JaxModelConfig(**MCFG))
        jf = tuple(jnp.asarray(f) for f in feats)
        want = 0.5 * (np.asarray(f1.apply({"params": params["F1"]}, jf, False))
                      + np.asarray(f2.apply({"params": params["F2"]}, jf, False)))
    carried = params_from_jax(params, stats)
    head = get_models(ModelConfig(**MCFG))[1].double()
    head.load_state_dict(_averaged_head_params(carried["F1"], carried["F2"], torch.float64))
    with torch.no_grad():
        got = head(tuple(_nchw(f) for f in feats)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_late_fusion_mcd_iteration_matches_jax_fp64(weights):
    params, stats = weights
    rng = np.random.RandomState(15)
    xs, xt = rng.randn(B, H, W, 6), rng.randn(B, H, W, 6)
    ys = rng.randint(0, NC, (B, H, W))
    ys[0, :3] = 255
    jcfg, tcfg = JaxModelConfig(**MCFG), JaxTrainConfig(**TCFG)
    with x64():
        tx_g = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        tx_f = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        p = jax.tree.map(jnp.asarray, params)
        state = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=jax.random.key(1))
        step = jax.jit(jax_make_mcd_step(*jax_get_models(jcfg), tx_g, tx_f, tcfg))
        state, metrics = step(state, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
        want_metrics = {k: float(v) for k, v in metrics.items()}
        want_params = _tree_np(state.params)
        want_stats = _tree_np(state.batch_stats["G"])

    port = create_train_state(ModelConfig(**MCFG), TrainConfig(**TCFG), device="cpu",
                              params=params_from_jax(params, stats))
    got_metrics = make_mcd_step(TrainConfig(**TCFG), False, torch.float64)(
        port, _nchw(xs), torch.from_numpy(ys), _nchw(xt))
    for k in ("loss_source", "loss_b", "loss_dis", "lr"):
        np.testing.assert_allclose(float(got_metrics[k]), want_metrics[k], rtol=REL, atol=0,
                                   err_msg=k)
    p, s = params_to_jax(port.params())
    assert jax.tree.structure(p) == jax.tree.structure(want_params)
    assert _max_rel_err(p, want_params) < REL  # both trunks, all four heads
    assert _max_rel_err(s["G"], want_stats) < REL
