"""Port of the model stack (upsample, PixelClassifier, DRN trunk, averaged
head, weight carry-over, init) against the JAX modules.

The trunk and heads are compared in float64 on both sides
(``jax_enable_x64``, ModelConfig dtype float64) with JAX's
parameters carried through ``params_from_jax``: the two differ only in
summation order, so 1e-9 relative to the output scale holds them. The
averaged head is checked against the two-apply mean in float64 to 1e-12,
as the JAX tester's own test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_params, port_params_jax_layout, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.models.heads import PixelClassifier as JaxPixelClassifier
from mcseg_tpu.ops.upsample import upsample_matmul
from mcseg_tpu_torch.core.config import ModelConfig
from mcseg_tpu_torch.eval.tester import _averaged_head_params
from mcseg_tpu_torch.models.factory import get_models, init_models
from mcseg_tpu_torch.models.heads import PixelClassifier
from mcseg_tpu_torch.ops.upsample import upsample_logits
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", ["convt", "resize"])
def test_upsample_modes_match_jax_matmul_form(mode):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 5, 4)
    with x64():
        want = np.asarray(upsample_matmul(jnp.asarray(x), 48, 40, mode))
    got = _nhwc(upsample_logits(_nchw(x), 8, mode))
    assert got.shape == want.shape == (2, 48, 40, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["convt", "resize"])
def test_pixel_classifier_matches_jax(mode):
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 6, 8, 32)
    kernel = rng.randn(1, 1, 32, 5) * 0.2
    bias = rng.randn(5) * 0.1
    with x64():
        head = JaxPixelClassifier(5, upsample=mode, dtype=jnp.float64)
        want = np.asarray(head.apply(
            {"params": {"score": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}},
            jnp.asarray(feat)))
    ours = PixelClassifier(32, 5, upsample=mode).double()
    ours.load_state_dict(params_from_jax(
        {"G": {}, "F1": {"score": {"kernel": kernel, "bias": bias}}, "F2": {}}, {})["F1"])
    got = ours(_nchw(feat))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("net", ["drn_d_14", "drn_d_22"])
def test_drn_forward_matches_jax_fp64(net):
    jcfg = JaxModelConfig(net=net, input_ch=6, n_class=8, dtype="float64")
    params, stats = jax_params(jcfg, img_hw=(32, 24), seed=3)
    x = np.random.RandomState(2).randn(2, 32, 24, 6)
    with x64():
        g, _, _ = jax_get_models(jcfg)
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731 (BN stats too)
        want = np.asarray(g.apply(
            {"params": jax.tree.map(f64, params["G"]),
             "batch_stats": jax.tree.map(f64, stats["G"])},
            jnp.asarray(x), False))
    tg, _, _ = get_models(ModelConfig(net=net, input_ch=6, n_class=8))
    tg.load_state_dict(params_from_jax(params, stats)["G"])
    tg = tg.double().eval()
    with torch.no_grad():
        got = _nhwc(tg(_nchw(x).to(memory_format=torch.channels_last)))
    assert got.shape == want.shape == (2, 4, 3, 512)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_averaged_head_equals_two_apply_mean():
    rng = np.random.RandomState(4)
    feat = _nchw(rng.randn(2, 3, 4, 16))
    f1, f2, avg = (PixelClassifier(16, 6).double() for _ in range(3))
    for f in (f1, f2):
        with torch.no_grad():
            f.score.weight.normal_()
            f.score.bias.normal_()
    avg.load_state_dict(_averaged_head_params(
        {k: v.float() for k, v in f1.state_dict().items()},
        {k: v.float() for k, v in f2.state_dict().items()}, torch.float64))
    f1.load_state_dict({k: v.float().double() for k, v in f1.state_dict().items()})
    f2.load_state_dict({k: v.float().double() for k, v in f2.state_dict().items()})
    with torch.no_grad():
        want = 0.5 * (f1(feat) + f2(feat))
        got = avg(feat)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)
    # bf16/fp32 compute averages in float32 parameter space
    p = _averaged_head_params(f1.state_dict(), f2.state_dict(), torch.bfloat16)
    assert all(v.dtype == torch.float32 for v in p.values())


def test_params_from_jax_covers_every_tensor_and_raises_on_leftovers():
    jcfg = JaxModelConfig(net="drn_d_14", input_ch=6, n_class=8, dtype="float32")
    params, stats = jax_params(jcfg, img_hw=(16, 16))
    sd = params_from_jax(params, stats)
    g, f1, f2 = get_models(ModelConfig(net="drn_d_14", input_ch=6, n_class=8))
    for mod, name in ((g, "G"), (f1, "F1"), (f2, "F2")):
        mod.load_state_dict(sd[name], strict=True)  # no missing, no unexpected
    k = params["G"]["conv0"]["kernel"]
    np.testing.assert_array_equal(sd["G"]["conv0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["G"]["bn0.running_var"].numpy(), stats["G"]["bn0"]["var"])
    bad = {**params, "G": {**params["G"], "stray": {"kernel": k, "gamma": k}}}
    with pytest.raises(KeyError):
        params_from_jax(bad, stats)
    with pytest.raises(KeyError):
        params_from_jax(params, {**stats, "G": {**stats["G"], "ghost_bn": {"mean": 0, "var": 1}}})
    no_stats = {**stats, "G": {k: v for k, v in stats["G"].items() if k != "bn0"}}
    with pytest.raises(KeyError):
        params_from_jax(params, no_stats)
    # the Bottleneck, arch C and late-fusion trees (names and shapes of the
    # JAX initializer's, by jax.eval_shape) map by name alone too
    for kw, stray in ((dict(net="drn_d_54"), ("layer5", "block1", "bn3")),
                      (dict(net="drn_c_26"), ("layer8", "block0", "bn2")),
                      (dict(net="drn_d_14", fusion="late"), ("hha_trunk", "layer3", "block0", "bn1"))):
        jcfg = JaxModelConfig(input_ch=6, n_class=8, dtype="float32", **kw)
        params, stats = port_params_jax_layout(jcfg, img_hw=(16, 16))
        sd = params_from_jax(params, stats)
        for mod, name in zip(get_models(ModelConfig(input_ch=6, n_class=8, **kw)),
                             ("G", "F1", "F2")):
            mod.load_state_dict(sd[name], strict=True)
        bn = stats["G"]
        for key in stray[:-1]:
            bn = bn[key]
        bn[stray[-1]]["ghost"] = np.zeros(1)  # a statistic the port has no place for
        with pytest.raises(KeyError):
            params_from_jax(params, stats)


def test_init_models_seeded_and_matches_jax_statistics():
    cfg = ModelConfig(net="drn_d_22", input_ch=6, n_class=40)
    a = init_models(cfg, torch.Generator().manual_seed(0))
    b = init_models(cfg, torch.Generator().manual_seed(0))
    c = init_models(cfg, torch.Generator().manual_seed(1))
    assert all(torch.equal(a["G"][k], b["G"][k]) for k in a["G"])
    assert not torch.equal(a["G"]["conv0.weight"], c["G"]["conv0.weight"])
    # Kaiming fan-out normal: std sqrt(2 / (k*k*out)); 512-ch 3x3 conv
    w = a["G"]["layer8.conv0.weight"]
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 512))) < 0.02 * np.sqrt(2.0 / (9 * 512))
    # shapes agree with the JAX initializer's tree, tensor by tensor
    jp, js = jax_params(JaxModelConfig(net="drn_d_22", input_ch=6, n_class=40,
                                       dtype="float32"), img_hw=(16, 16))
    carried = params_from_jax(jp, js)
    for name in ("G", "F1", "F2"):
        assert {k: tuple(v.shape) for k, v in a[name].items()} == \
               {k: tuple(v.shape) for k, v in carried[name].items()}
    assert float(a["F1"]["score.bias"].abs().max()) == 0.0
