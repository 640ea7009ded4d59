"""The port's DRN zoo beyond arch D BasicBlock trunks — drn_d_54 and
drn_d_105 (Bottleneck) and drn_c_26 and drn_c_42 (arch C) — against the
JAX modules, in float64 on both sides. The weights are seeded in the JAX
layout with the tree of JAX's initializer (``port_params_jax_layout``: its
names and shapes by ``jax.eval_shape``) and carried into the port by
``params_from_jax`` (a strict load: every tensor placed, none left).

Eval mode: the feature map. Train mode: the feature map and every BN
running mean and variance after one forward (batch statistics, flax's
biased variance update). Bound: 1e-9 relative to the largest output value
for features and per statistic leaf; the two sides differ in summation
order only (measured: 2e-15 in eval mode; in train mode up to 4.4e-12,
drn_d_105's features, where batch statistics over 24 pixels per channel
amplify the order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_params_jax_layout, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu_torch.core.config import ModelConfig
from mcseg_tpu_torch.models.factory import get_models
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

REL = 1e-9


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize("net", ["drn_d_54", "drn_d_105", "drn_c_26", "drn_c_42"])
def test_drn_zoo_forward_matches_jax_fp64(net):
    jcfg = JaxModelConfig(net=net, input_ch=4, n_class=8, dtype="float64")
    params, stats = port_params_jax_layout(jcfg, img_hw=(32, 24), seed=9)
    x = np.random.RandomState(10).randn(2, 32, 24, 4)
    carried = params_from_jax(params, stats)["G"]
    for train in (False, True):  # eval: running statistics; train: batch statistics
        with x64():
            g, _, _ = jax_get_models(jcfg)
            want, mut = g.apply({"params": _f64(params["G"]), "batch_stats": _f64(stats["G"])},
                                jnp.asarray(x), train, mutable=["batch_stats"])
            want = np.asarray(want)
            new_stats = jax.tree.map(np.asarray, mut["batch_stats"])
        tg, _, _ = get_models(ModelConfig(net=net, input_ch=4, n_class=8))
        tg.load_state_dict(carried)  # strict
        tg = tg.double().train(train)
        with torch.no_grad():
            got = tg(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (2, 4, 3, 512)
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max(),
                                   err_msg=f"train={train}")
        if train:
            _, s = params_to_jax({"G": tg.state_dict()})
            errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / np.abs(b).max()),
                                s["G"], new_stats)
            assert max(jax.tree.leaves(errs)) < REL
