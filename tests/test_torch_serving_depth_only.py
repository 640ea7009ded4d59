"""Depth-only serving: an ``input_ch`` 1 checkpoint serves a batch that
carries no RGB plane, as the JAX package's ``make_serve_fn`` does
(``mcseg_tpu/eval/serving.py:77-93``), and every other checkpoint refuses
one with JAX's message.

drn_d_22, 8 classes, 32x32, float32 on both sides, batch 2 of depth in
metres; the JAX state's weights carried by ``params_from_jax``. Bounds:
the served class map equals JAX's exactly; the logits (the inference core
with the zero RGB plane both servers fill in) within 1e-4 absolute, as
``tests/test_torch_slice.py`` (measured ~1e-6: the two frameworks' float32
convolutions sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.eval.serving import make_serve_fn as jax_make_serve_fn
from mcseg_tpu.eval.tester import make_infer_fn as jax_make_infer_fn
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.eval.serving import make_serve_fn
from mcseg_tpu_torch.eval.tester import make_infer_fn
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

LOGITS_ATOL = 1e-4


def _setup(input_ch):
    """(JAX config, port config, JAX params, batch_stats, port params)."""
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_22", input_ch=input_ch, n_class=8, dtype="float32"),
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic", batch_size=2,
                           train_img_shape=(32, 32), test_img_shape=(32, 32),
                           input_ch=input_ch),
        train=JaxTrainConfig())
    state, _, _ = jax_create_train_state(cfg.model, cfg.train, jax.random.key(0),
                                         img_shape=(32, 32))
    to_np = jax.tree.map(np.asarray, (state.params, state.batch_stats))
    return (cfg, ExperimentConfig.from_dict(cfg.to_dict()), state.params, state.batch_stats,
            params_from_jax(*to_np))


@pytest.fixture(scope="module")
def depth_only():
    return _setup(1)


def _depth(seed=3):
    return (np.random.RandomState(seed).rand(2, 32, 32) * 4 + 0.5).astype(np.float32)


def test_depth_only_batch_serves_as_jax(depth_only):
    cfg, pcfg, params, stats, pparams = depth_only
    batch = {"depth": _depth()}
    want = np.asarray(jax.jit(jax_make_serve_fn(cfg, params, stats))(batch))
    got = make_serve_fn(pcfg, pparams, device="cpu")(batch)
    assert tuple(got.shape) == (2, 32, 32) and str(got.dtype) == "torch.int32"
    np.testing.assert_array_equal(got.numpy(), want)
    # the inference core behind both servers, on the zero RGB plane they fill in
    filled = {"image": np.zeros((2, 32, 32, 3), np.uint8), **batch}
    want_logits, _, _ = jax.jit(jax_make_infer_fn(cfg, out_shape=(32, 32)))(
        params, stats, {**filled, "label": jnp.zeros((2, 32, 32), jnp.uint8)})
    got_logits, _, _ = make_infer_fn(pcfg, pparams, device="cpu", out_shape=(32, 32))(filled)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0,
                               atol=LOGITS_ATOL)
    # RGB values are never read at input_ch 1: any image serves the same map
    noise = np.random.RandomState(4).randint(0, 256, (2, 32, 32, 3)).astype(np.uint8)
    again = make_serve_fn(pcfg, pparams, device="cpu")({"image": noise, **batch})
    np.testing.assert_array_equal(again.numpy(), want)


def _jax_refusal(cfg, params, stats, batch):
    with pytest.raises(ValueError) as e:
        jax_make_serve_fn(cfg, params, stats)(batch)
    return str(e.value)


@pytest.mark.parametrize("input_ch", [3, 6])
def test_rgb_checkpoint_refuses_a_batch_without_image_as_jax(input_ch):
    cfg, pcfg, params, stats, pparams = _setup(input_ch)
    batch = {"depth": _depth()}
    want = _jax_refusal(cfg, params, stats, batch)
    with pytest.raises(ValueError) as ours:
        make_serve_fn(pcfg, pparams, device="cpu")(batch)
    assert str(ours.value) == want
    assert f"input_ch={input_ch} consumes RGB" in want


def test_depth_only_batch_without_a_plane_refused_as_jax(depth_only):
    cfg, pcfg, params, stats, pparams = depth_only
    batch = {"label": np.zeros((2, 32, 32), np.uint8)}
    want = _jax_refusal(cfg, params, stats, batch)
    with pytest.raises(ValueError) as ours:
        make_serve_fn(pcfg, pparams, device="cpu")(batch)
    assert str(ours.value) == want and "needs a 'depth' (or 'hha'/'ir') plane" in want
