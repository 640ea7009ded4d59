"""The port's last two trunks against the JAX package's modules, in float64
on both sides: FCN8s on VGG16 (``mcseg_tpu/models/fcn_vgg.py``) and PSPNet
(``mcseg_tpu/models/psp_net.py``).

The weights are seeded in the JAX layout with the tree of JAX's
initializer (``_torch_parity.port_params_jax_layout``: its names and
shapes by ``jax.eval_shape``; BN statistics and every conv bias
randomized) and carried into the port by ``params_from_jax`` (a strict
load: every tensor placed, none left).

  * VGG G in eval mode (dropout off) at 32x32, where every ceil-mode pool
    and decoder crop is a no-op, and at 40x56, where they act (/8 5x7,
    /16 3x4, /32 2x2); the FCN8s head at both sizes in ``convt`` and
    ``resize``. The JAX head casts its scores to exactly float32 even under
    the float64 oracle; the float64 comparison lifts that cast
    (``_torch_parity.lift_fcn8s_float32_cast``), and one case keeps it and
    holds the two within float32 rounding.
  * PSP G in eval and train mode (output and every BN running mean and
    variance) at 48x64 (/8 6x8: bins 1 and 2 pool exactly, 3 and 6 take
    the shrinking antialiased resize first) and 24x32 (/8 3x4: bin 2 and 3
    shrink, bin 6 grows from 3x4 to 6x6, and the resize back to 3x4
    shrinks).
  * The tester's averaged FCN8s head (parameters averaged) against JAX's
    two-apply mean.

Bound: 1e-9 relative to the largest value of the compared quantity, as
``tests/test_torch_trunks.py`` (the sides differ in summation order;
measured below 3e-12, the largest in PSP's train-mode features, where
batch statistics over 12-48 pixels per channel amplify the order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import lift_fcn8s_float32_cast, port_params_jax_layout, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.models.factory import init_models as jax_init_models
from mcseg_tpu.train.multitask import init_multitask_state as jax_init_multitask_state
from mcseg_tpu_torch.core.config import ModelConfig
from mcseg_tpu_torch.eval.tester import _averaged_head_params
from mcseg_tpu_torch.models.factory import get_aux_heads, get_models, init_aux_heads
from mcseg_tpu_torch.models.fcn_vgg import FCN8sClassifier, VGG16FeatureGenerator
from mcseg_tpu_torch.models.heads import PixelClassifier
from mcseg_tpu_torch.models.psp_net import PSPFeatureGenerator
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

REL = 1e-9
NC = 5


def _mcfg(net, jax_side=False, **kw):
    cls = JaxModelConfig if jax_side else ModelConfig
    return cls(net=net, input_ch=4, n_class=NC, dtype="float64", **kw)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _assert_close(got, want, rel=REL, msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(), err_msg=msg)


@pytest.fixture(scope="module")
def vgg_weights():
    """FCN8s weights in the JAX layout (float64 numpy) and carried."""
    params, stats = port_params_jax_layout(_mcfg("fcn8s_vgg16", True), img_hw=(32, 32), seed=21)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    return params, params_from_jax(params, stats)


@pytest.fixture(scope="module")
def vgg_port(vgg_weights):
    """The port's G, F1 and F2 in float64 from the carried weights."""
    _, carried = vgg_weights
    mods = get_models(_mcfg("fcn8s_vgg16"))
    for m, name in zip(mods, ("G", "F1", "F2")):
        m.double().load_state_dict(carried[name])  # strict
        m.eval()
    return mods


@pytest.mark.parametrize("net", ["fcn", "fcn8s", "fcn8s_vgg16", "psp", "psp_net", "pspnet"])
def test_factory_builds_every_jax_name(net):
    with torch.device("meta"):  # structure only: no memory, no init
        g, f1, f2 = get_models(_mcfg(net))
    fcn = net.startswith("fcn")
    assert isinstance(g, VGG16FeatureGenerator if fcn else PSPFeatureGenerator)
    assert all(isinstance(f, FCN8sClassifier if fcn else PixelClassifier) for f in (f1, f2))
    assert g.out_dim == (4096 if fcn else 512)


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)], ids=["32x32", "40x56"])
def test_vgg_g_and_fcn8s_head_match_jax_fp64(vgg_weights, vgg_port, hw, monkeypatch):
    params, _ = vgg_weights
    tg, tf1, _ = vgg_port
    x = np.random.RandomState(22).randn(2, *hw, 4)
    lift_fcn8s_float32_cast(monkeypatch)
    with x64():
        g, _, _ = jax_get_models(_mcfg("fcn8s_vgg16", True))
        want = jax.jit(lambda p, a: g.apply({"params": p}, a, False))(_f64(params["G"]),
                                                                      jnp.asarray(x))
    with torch.no_grad():
        got = tg(_nchw(x))
    assert [f.shape[1:3] for f in want] == [(-(-hw[0] // s), -(-hw[1] // s)) for s in (8, 16, 32)]
    for name, a, b in zip(("pool3", "pool4", "drop7"), got, want):
        _assert_close(_nhwc(a), np.asarray(b), msg=name)
    for mode in ("convt", "resize"):
        with x64():
            _, f1, _ = jax_get_models(_mcfg("fcn8s_vgg16", True, upsample=mode))
            want_logits = np.asarray(jax.jit(lambda p, f: f1.apply({"params": p}, f, False))(
                _f64(params["F1"]), want))
        tf1.upsample = mode
        with torch.no_grad():
            logits = tf1(got)
        assert logits.dtype == torch.float64 and tuple(logits.shape) == (2, NC, *hw)
        _assert_close(_nhwc(logits), want_logits, msg=mode)


def test_fcn8s_head_float32_cast_is_the_only_difference(vgg_weights, vgg_port):
    """Without the lift, JAX's float64 head rounds its scores to float32:
    the port's float64 logits are then within float32 rounding of it."""
    params, _ = vgg_weights
    _, tf1, _ = vgg_port
    rng = np.random.RandomState(23)
    feats = tuple(rng.randn(2, h, w, c) for h, w, c in ((5, 7, 256), (3, 4, 512), (2, 2, 4096)))
    with x64():
        _, f1, _ = jax_get_models(_mcfg("fcn8s_vgg16", True))
        want = f1.apply({"params": _f64(params["F1"])}, tuple(map(jnp.asarray, feats)), False)
    assert want.dtype == jnp.float32
    tf1.upsample = "convt"
    with torch.no_grad():
        got = _nhwc(tf1(tuple(_nchw(f) for f in feats)))
    err = np.abs(got - np.asarray(want, np.float64)).max() / np.abs(want).max()
    assert 1e-12 < err < 1e-6


def test_averaged_fcn8s_head_equals_jax_two_apply_mean(vgg_weights, vgg_port, monkeypatch):
    """The tester averages F1 and F2 in parameter space; JAX's tester applies
    both FCN8s heads and averages the logits (``_averaged_head_params``
    returns None for them). The head is affine in its parameters (score
    convs, fixed upsamples, crops, adds), so the two are one function."""
    params, carried = vgg_weights
    rng = np.random.RandomState(24)
    feats = tuple(rng.randn(2, h, w, c) for h, w, c in ((5, 7, 256), (3, 4, 512), (2, 2, 4096)))
    lift_fcn8s_float32_cast(monkeypatch)
    with x64():
        _, f1, f2 = jax_get_models(_mcfg("fcn8s_vgg16", True))
        jf = tuple(map(jnp.asarray, feats))
        want = 0.5 * (np.asarray(f1.apply({"params": _f64(params["F1"])}, jf, False))
                      + np.asarray(f2.apply({"params": _f64(params["F2"])}, jf, False)))
    head = FCN8sClassifier(4096, NC, upsample="convt").double()
    head.load_state_dict(_averaged_head_params(carried["F1"], carried["F2"], torch.float64))
    with torch.no_grad():
        got = _nhwc(head(tuple(_nchw(f) for f in feats)))
    _assert_close(got, want, rel=1e-12)


@pytest.mark.parametrize("hw", [(48, 64), (24, 32)], ids=["48x64", "24x32"])
def test_psp_g_matches_jax_fp64(hw):
    jcfg = _mcfg("psp", True)
    params, stats = port_params_jax_layout(jcfg, img_hw=hw, seed=25)
    x = np.random.RandomState(26).randn(2, *hw, 4)
    carried = params_from_jax(params, stats)["G"]
    g, _, _ = jax_get_models(jcfg)
    for train in (False, True):  # eval: running statistics; train: batch statistics
        with x64():
            want, mut = jax.jit(lambda p, s, a: g.apply(
                {"params": p, "batch_stats": s}, a, train, mutable=["batch_stats"]))(
                _f64(params["G"]), _f64(stats["G"]), jnp.asarray(x))
            want = np.asarray(want)
            new_stats = jax.tree.map(np.asarray, mut["batch_stats"])
        tg, _, _ = get_models(_mcfg("psp"))
        tg.load_state_dict(carried)  # strict
        tg = tg.double().train(train)
        with torch.no_grad():
            got = _nhwc(tg(_nchw(x).contiguous(memory_format=torch.channels_last)))
        assert got.shape == want.shape == (2, hw[0] // 8, hw[1] // 8, 512)
        _assert_close(got, want, msg=f"train={train}")
        if train:
            _, s = params_to_jax({"G": tg.state_dict()})
            errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
                                s["G"], new_stats)
            assert max(jax.tree.leaves(errs)) < REL


@pytest.mark.parametrize("net", ["fcn8s_vgg16", "psp"])
def test_late_fusion_refused_for_non_drn_trunks_as_jax_fails(net):
    late = dict(net=net, input_ch=6, n_class=NC, fusion="late")
    with pytest.raises(ValueError, match=f"unknown DRN variant '{net}'"):
        get_models(ModelConfig(**late))
    # JAX builds the modules and fails on the generator's first forward
    with pytest.raises(ValueError, match=f"unknown DRN variant '{net}'"):
        jax.eval_shape(lambda k: jax_init_models(JaxModelConfig(**late), k, img_shape=(32, 32)),
                       jax.random.key(0))


def test_multitask_refused_for_fcn8s_as_jax_fails():
    cfg = dict(net="fcn8s_vgg16", input_ch=3, n_class=NC)
    with pytest.raises(ValueError, match="--net fcn8s_vgg16 returns three skip maps"):
        get_aux_heads(ModelConfig(**cfg), ("D",))
    assert get_aux_heads(ModelConfig(**cfg), ()) == {}  # the other trainers are unaffected
    with pytest.raises(AttributeError):  # flax's depth head gets the three skip maps
        jax.eval_shape(lambda k: jax_init_multitask_state(
            JaxModelConfig(**cfg), JaxTrainConfig(), k, img_shape=(32, 32))[0],
            jax.random.key(0))


def test_psp_aux_heads_take_its_512_channels():
    cfg = dataclasses.replace(_mcfg("psp"), dtype="float32")
    heads = get_aux_heads(cfg, ("D", "B"))
    assert heads["D"].conv.in_channels == heads["B"].conv.in_channels == 512
    ours = init_aux_heads(cfg, ("D", "B"), torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda k: jax_init_multitask_state(
        JaxModelConfig(net="psp", input_ch=4, n_class=NC), JaxTrainConfig(), k,
        img_shape=(32, 32), with_boundary=True)[0].params, jax.random.key(0))
    got, _ = params_to_jax(ours)
    for k in ("D", "B"):
        assert jax.tree.map(np.shape, got[k]) == jax.tree.map(lambda s: tuple(s.shape), want[k])
