"""One training iteration of the last two trunks against the JAX package's
steps, in float64 on both sides, and the port's dropout.

  * MCD (``make_mcd_step``) on ``fcn8s_vgg16`` at 32x32, batch 2, ``num_k``
    2: the shape ``tests/test_mcd_torch_parity.py`` runs (conv6 alone holds
    103 M parameters, ~0.8 GB per float64 copy).
  * The source-only step (``make_source_step``) on ``fcn8s_vgg16``.
  * MCD on ``psp`` at 48x64, batch 4 (its /8 map 6x8 takes the PPM's
    exact pools and its shrinking resize). At batch 2 the 1-bin branch's
    BN normalizes two values per channel, and its gradient is cancellation
    noise: two float64 summation orders then move G's update by 4e-4.

Both sides start from the same weights in the JAX layout
(``_torch_parity.port_params_jax_layout``, carried by ``params_from_jax``),
3 input channels, 5 classes, SGD with momentum 0.9 and weight decay 1e-3,
the poly lr. JAX's step runs jitted with its own dropout; the port gets
the same masks: ``_torch_parity.flax_vgg_dropout_masks`` draws them from
the keys the JAX step splits off its state rng (A ``ka``; B ``kb1``,
``kb2``; C ``fold_in(kc, i)`` per repetition; the source step's one key),
in the port's call order, and ``GivenMasks`` hands them out. The JAX FCN8s
head's float32 cast is lifted to float64 (``lift_fcn8s_float32_cast``).

Bound: every loss, every parameter and every BN running mean and variance
within 1e-9 of the JAX value, relative to that leaf's largest magnitude,
as ``tests/test_torch_mcd.py`` (measured: FCN8s 3e-16 in the parameters,
PSP 1.4e-10 in G's, 4e-10 in the BN statistics). A mask handed to the
wrong forward moves the losses by 1e-3 or more.

Port only: with lr 0 and no BN, step C's second repetition sees a new
mask (the counterpart of ``tests/test_mcd_torch_parity.py:189``); the
default source repeats its masks for a step and changes them with it; a
``Dropout`` in train mode without a source raises.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from _torch_parity import (
    flax_vgg_dropout_masks, lift_fcn8s_float32_cast, port_params_jax_layout, x64)
import mcseg_tpu.train.mcd as jax_mcd
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.source import make_source_step as jax_make_source_step
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.models.fcn_vgg import Dropout, GivenMasks, SeededMasks
from mcseg_tpu_torch.models.heads import PixelClassifier
from mcseg_tpu_torch.train.mcd import make_mcd_step
from mcseg_tpu_torch.train.optim import get_optimizer
from mcseg_tpu_torch.train.source import make_source_step
from mcseg_tpu_torch.train.state import MCDTrainState, create_train_state
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

NC, REL = 5, 1e-9
TCFG = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2, d_loss="diff",
            lr_schedule="poly", lr_power=0.9, max_steps=8)


def _mcfg(net, jax_side=False, method="MCD"):
    cls = JaxModelConfig if jax_side else ModelConfig
    return cls(net=net, input_ch=3, n_class=NC, dtype="float64", upsample="convt",
               method=method)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _max_rel_err(got_tree, want_tree):
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


def _batch(b, hw, seed):
    rng = np.random.RandomState(seed)
    ys = rng.randint(0, NC, (b, *hw))
    ys[0, :3] = 255  # an ignore region
    return rng.randn(b, *hw, 3), ys, rng.randn(b, *hw, 3)


def _jax_step(net, params, stats, batch, mcd):
    """JAX's jitted step from ``params`` on ``batch``: (metrics, params,
    G's batch_stats, the dropout masks it drew in the port's call order)."""
    tcfg = JaxTrainConfig(**TCFG)
    xs, ys, xt = batch
    with x64():
        tx_g = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        tx_f = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        p = jax.tree.map(jnp.asarray, params)
        rng = jax.random.key(1)
        state = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=rng)
        mods = jax_get_models(_mcfg(net, True, "MCD" if mcd else "source"))
        if mcd:
            step = jax.jit(jax_make_mcd_step(*mods, tx_g, tx_f, tcfg))
            state, metrics = step(state, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(xt))
            _, ka, kb1, kb2, kc = jax.random.split(rng, 5)
            keys = [ka, kb1, kb2] + [jax.random.fold_in(kc, i) for i in range(tcfg.num_k)]
        else:
            step = jax.jit(jax_make_source_step(*mods, tx_g, tx_f, tcfg))
            state, metrics = step(state, jnp.asarray(xs), jnp.asarray(ys))
            keys = [jax.random.split(rng)[1]]
        b, h, w = xs.shape[:3]
        masks = flax_vgg_dropout_masks(keys, (b, -(-h // 32), -(-w // 32), 4096)) \
            if net == "fcn8s_vgg16" else []
        out = ({k: float(v) for k, v in metrics.items()}, _tree_np(state.params),
               _tree_np(state.batch_stats["G"]), masks)
    del state, p
    gc.collect()
    return out


@pytest.fixture(scope="module")
def vgg_start():
    """FCN8s weights in the JAX layout, float64 numpy (~1.1 GB)."""
    params, stats = port_params_jax_layout(_mcfg("fcn8s_vgg16", True), img_hw=(32, 32), seed=31)
    return _tree_np(params), _tree_np(stats)


def _check_iteration(net, start, batch, mcd, monkeypatch):
    lift_fcn8s_float32_cast(monkeypatch)
    # step C's scan as a loop, not unrolled: the same function, a shorter
    # XLA compile
    monkeypatch.setattr(jax_mcd, "_STEP_C_UNROLL", False)
    params, stats = start
    want_metrics, want_params, want_stats, masks = _jax_step(net, params, stats, batch, mcd)

    state = create_train_state(_mcfg(net, method="MCD" if mcd else "source"),
                               TrainConfig(**TCFG), device="cpu",
                               params=params_from_jax(params, stats))
    if masks:
        assert isinstance(state.masks, SeededMasks)  # the default, replaced by JAX's
        state.install_masks(GivenMasks(masks))
    xs, ys, xt = batch
    if mcd:
        step = make_mcd_step(TrainConfig(**TCFG), False, torch.float64)
        got = step(state, _nchw(xs), torch.from_numpy(ys), _nchw(xt))
    else:
        got = make_source_step(TrainConfig(**TCFG), torch.float64)(
            state, _nchw(xs), torch.from_numpy(ys))
    if masks:
        assert state.masks.drawn == len(masks) == (10 if mcd else 2)
    assert got.keys() == want_metrics.keys()
    for k, want in want_metrics.items():
        np.testing.assert_allclose(float(got[k]), want, rtol=REL, atol=0, err_msg=k)
    p, s = params_to_jax(state.params())
    assert jax.tree.structure(p) == jax.tree.structure(want_params)
    for name in ("G", "F1", "F2"):
        assert _max_rel_err(p[name], want_params[name]) < REL, name
    if want_stats:  # PSP: every running mean and variance
        assert _max_rel_err(s["G"], want_stats) < REL


def test_fcn8s_mcd_iteration_matches_jax_fp64(vgg_start, monkeypatch):
    _check_iteration("fcn8s_vgg16", vgg_start, _batch(2, (32, 32), 32), True, monkeypatch)


def test_fcn8s_source_step_matches_jax_fp64(vgg_start, monkeypatch):
    _check_iteration("fcn8s_vgg16", vgg_start, _batch(2, (32, 32), 33), False, monkeypatch)


def test_psp_mcd_iteration_matches_jax_fp64(monkeypatch):
    params, stats = port_params_jax_layout(_mcfg("psp", True), img_hw=(48, 64), seed=35)
    _check_iteration("psp", (_tree_np(params), _tree_np(stats)), _batch(4, (48, 64), 36),
                     True, monkeypatch)


class _DropG(nn.Module):
    """A stride-8 conv then ``Dropout``: no BN, so only a mask can make
    two forwards of the same parameters differ."""

    out_dim = 4

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, self.out_dim, 8, stride=8)
        self.drop = Dropout()

    def forward(self, x):
        return self.drop(self.conv(x))


class _Recording:
    """A mask source that keeps what the source it wraps hands out."""

    def __init__(self, source):
        self.source, self.masks = source, []

    def reseed(self, step):
        self.source.reseed(step)

    def __call__(self, shape, device):
        self.masks.append(self.source(shape, device))
        return self.masks[-1]


def test_step_c_draws_a_fresh_mask_each_repetition():
    """lr 0 freezes the parameters, so step C's last loss under num_k 2 can
    differ from num_k 1's only through the mask of its second repetition.
    Both runs share one default source: the step reseeds it from the step,
    so the second run draws the first run's masks again."""
    torch.manual_seed(0)
    g, f1, f2 = _DropG().double(), PixelClassifier(4, NC).double(), PixelClassifier(4, NC).double()
    xs, ys, xt = _batch(2, (16, 16), 37)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    source = _Recording(SeededMasks(seed=7, device="cpu"))

    def run(num_k):
        g.load_state_dict(before)
        cfg = TrainConfig(**{**TCFG, "lr": 0.0, "num_k": num_k, "lr_schedule": "constant"})
        opt = dict(opt="sgd", lr=0.0, momentum=0.0, weight_decay=0.0)
        state = MCDTrainState(g, f1, f2, get_optimizer(g.parameters(), **opt),
                              get_optimizer([*f1.parameters(), *f2.parameters()], **opt),
                              step=0, gen=torch.Generator())
        state.install_masks(source)
        source.masks = []
        metrics = make_mcd_step(cfg, False, torch.float64)(
            state, _nchw(xs), torch.from_numpy(ys), _nchw(xt))
        assert all(torch.equal(v, before[k]) for k, v in g.state_dict().items())
        return float(metrics["loss_dis"]), source.masks

    loss_1, masks_1 = run(1)
    loss_2, masks_2 = run(2)
    assert (len(masks_1), len(masks_2)) == (4, 5)  # A, B source, B target, C x num_k
    # the same seed and step: every mask up to step C's first repetition
    # repeats, and its second repetition draws a new one
    assert all(torch.equal(a, b) for a, b in zip(masks_1, masks_2))
    assert not torch.equal(masks_2[3], masks_2[4])
    assert loss_2 != loss_1


def test_seeded_masks_follow_seed_and_step():
    a, b, c = SeededMasks(0, "cpu"), SeededMasks(0, "cpu"), SeededMasks(1, "cpu")
    shape = (2, 8, 3, 3)
    for step in (0, 5):
        for src in (a, b, c):
            src.reseed(step)
        first, again, other = a(shape, "cpu"), b(shape, "cpu"), c(shape, "cpu")
        assert first.dtype == torch.bool and torch.equal(first, again)  # a resumed run's
        assert not torch.equal(first, other)
        assert not torch.equal(first, a(shape, "cpu"))  # the next call of the step
        assert 0.3 < float(first.float().mean()) < 0.7
    a.reseed(0)
    b.reseed(1)
    assert not torch.equal(a(shape, "cpu"), b(shape, "cpu"))


def test_dropout_without_mask_source_raises_in_train_mode():
    drop = Dropout()
    x = torch.randn(2, 3, 4, 4)
    assert drop.eval()(x) is x  # eval: the identity, no source needed
    with pytest.raises(RuntimeError, match="no mask source"):
        drop.train()(x)
    keep = torch.rand(2, 3, 4, 4) < 0.5
    drop.mask_source = GivenMasks([keep])
    assert torch.equal(drop(x), torch.where(keep, 2 * x, torch.zeros(())))
    with pytest.raises(IndexError):
        drop(x)
