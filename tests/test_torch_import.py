"""Torch -> flax checkpoint import shim: layout transposes and ordered
shape-matching against a real torch module (SURVEY.md section 5 import shim)."""

import jax
import numpy as np
import torch
import torch.nn as tnn

from mcseg_tpu.core.config import ModelConfig
from mcseg_tpu.models.factory import init_models
from mcseg_tpu.utils.torch_import import (
    import_torch_state_dict,
    torch_conv_to_hwio,
)
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def test_conv_layout_transpose():
    w = np.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5).astype(np.float32)  # OIHW
    out = torch_conv_to_hwio(w)
    assert out.shape == (4, 5, 3, 2)
    np.testing.assert_array_equal(out[1, 2, :, 0], w[0, :, 1, 2])


def _mini_torch_trunk():
    """Conv/BN stack whose tensor order mirrors a tiny flax trunk."""
    return tnn.Sequential(
        tnn.Conv2d(3, 8, 3, padding=1, bias=False),
        tnn.BatchNorm2d(8),
        tnn.ReLU(),
        tnn.Conv2d(8, 8, 3, padding=1, bias=False),
        tnn.BatchNorm2d(8),
        tnn.ReLU(),
    )


def test_import_into_matching_flax_tree():
    import flax.linen as nn
    import jax.numpy as jnp

    class MiniTrunk(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            for i in range(2):
                x = nn.Conv(8, (3, 3), use_bias=False, name=f"conv{i}")(x)
                x = nn.BatchNorm(use_running_average=not train, name=f"bn{i}")(x)
                x = nn.relu(x)
            return x

    tm = _mini_torch_trunk()
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn_like(p) * 0.2)
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(8) * 0.1)
                m.running_var.copy_(torch.rand(8) + 0.5)

    fm = MiniTrunk()
    variables = fm.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    params, stats = import_torch_state_dict(
        tm.state_dict(), variables["params"], dict(variables["batch_stats"])
    )

    # forward parity
    x = np.random.RandomState(0).rand(1, 8, 8, 3).astype(np.float32)
    ours = fm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), False
    )
    theirs = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    theirs = theirs.detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=1e-4, atol=1e-5)


def test_import_shape_mismatch_raises():
    cfg = ModelConfig(net="drn_d_22", input_ch=3, n_class=4, dtype="float32")
    variables = init_models(cfg, jax.random.key(0), img_shape=(16, 16))
    bogus = {"w": torch.zeros(7, 7, 7, 7)}
    try:
        import_torch_state_dict(
            bogus, variables["params"]["G"], variables["batch_stats"]["G"]
        )
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_vgg16_imagenet_fc_to_conv_import():
    """torchvision-style VGG16 ImageNet state_dict seeds the FCN trunk: the
    fc6/fc7 Linears land in our conv6 (7x7) / conv7 (1x1) kernels via the
    fc->conv reshape (reference FCN8s surgery), and the 1000-class fc8 is
    ignored. Constructed in-test: torchvision is not installed here."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from mcseg_tpu.core.config import ModelConfig
    from mcseg_tpu.models.factory import get_models, init_models
    from mcseg_tpu.utils.torch_import import import_torch_state_dict

    rng = np.random.RandomState(0)
    sd = {}
    stages = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
    cin, idx = 3, 0
    for n_convs, ch in stages:
        for _ in range(n_convs):
            sd[f"features.{idx}.weight"] = rng.randn(ch, cin, 3, 3).astype(np.float32) * 0.05
            sd[f"features.{idx}.bias"] = rng.randn(ch).astype(np.float32) * 0.05
            cin = ch
            idx += 2  # conv, relu
        idx += 1  # pool
    sd["classifier.0.weight"] = rng.randn(4096, 512 * 7 * 7).astype(np.float32) * 0.01
    sd["classifier.0.bias"] = rng.randn(4096).astype(np.float32) * 0.01
    sd["classifier.3.weight"] = rng.randn(4096, 4096).astype(np.float32) * 0.01
    sd["classifier.3.bias"] = rng.randn(4096).astype(np.float32) * 0.01
    sd["classifier.6.weight"] = rng.randn(1000, 4096).astype(np.float32)  # unused
    sd["classifier.6.bias"] = rng.randn(1000).astype(np.float32)

    cfg = ModelConfig(net="fcn8s_vgg16", input_ch=3, n_class=4, dtype="float32")
    variables = init_models(cfg, jax.random.key(0), img_shape=(32, 32))
    params, stats = import_torch_state_dict(
        sd, variables["params"]["G"], variables["batch_stats"]["G"])

    want6 = np.transpose(
        sd["classifier.0.weight"].reshape(4096, 512, 7, 7), (2, 3, 1, 0))
    np.testing.assert_array_equal(np.asarray(params["conv6"]["kernel"]), want6)
    want7 = np.transpose(
        sd["classifier.3.weight"].reshape(4096, 4096, 1, 1), (2, 3, 1, 0))
    np.testing.assert_array_equal(np.asarray(params["conv7"]["kernel"]), want7)
    np.testing.assert_array_equal(
        np.asarray(params["conv1_1"]["kernel"]),
        np.transpose(sd["features.0.weight"], (2, 3, 1, 0)))

    g, _, _ = get_models(cfg)
    feats = g.apply({"params": params, "batch_stats": stats},
                    jnp.zeros((1, 32, 32, 3)), False)
    assert feats[2].shape == (1, 1, 1, 4096)
