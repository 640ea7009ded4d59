"""The serving slice as a whole: JAX ``make_serve_fn`` / ``evaluate`` vs the
port's, on identical parameters carried through ``params_from_jax``.

drn_d_14, RGB+HHA from raw depth (input_ch 6), 40 classes, 64x48,
float32 on both sides, batch 2, synthetic_shifted val samples.

Bounds: logits within 1e-4 absolute at a logit scale of ~0.9 (measured
1.3e-6 on the CPU: the two frameworks' float32 convolutions and HHA
reductions sum in different orders, and the HHA angle channel carries its
0.01 bound on the 0-255 scale); predictions agree on at least 99.9% of
pixels (argmax may flip only where two logits are within that bound).
The tester's confusion matrix must be identical, including the
ignore-labelled padding of a ragged tail batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_params
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.eval.serving import make_serve_fn as jax_make_serve_fn
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu.eval.tester import make_infer_fn as jax_make_infer_fn
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
from mcseg_tpu_torch.eval.serving import make_serve_fn
from mcseg_tpu_torch.eval.tester import evaluate, make_infer_fn
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

LOGITS_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=6, n_class=40, dtype="float32"),
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                           batch_size=2, test_img_shape=(64, 48), input_ch=6,
                           max_samples=3),
    )
    params, stats = jax_params(cfg.model, img_hw=(48, 64), seed=5)
    jparams = jax.tree.map(jnp.asarray, params)
    jstats = jax.tree.map(jnp.asarray, stats)
    # the port reads the JAX config through its dict (sidecar) form
    pcfg = ExperimentConfig.from_dict(cfg.to_dict())
    return cfg, pcfg, (jparams, jstats), params_from_jax(params, stats)


def test_serve_matches_jax(setup):
    cfg, pcfg, (jparams, jstats), pparams = setup
    ds = get_dataset("synthetic_shifted", pcfg.data, "val")
    raw = stack_samples(ds, [0, 1])
    request = {"image": raw["image"], "depth": raw["depth"]}

    want_logits, want_label, _ = jax.jit(jax_make_infer_fn(cfg))(jparams, jstats, raw)
    got_logits, got_label, _ = make_infer_fn(pcfg, pparams, device="cpu")(raw)
    assert tuple(got_logits.shape) == (2, 48, 64, 40)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=LOGITS_ATOL)
    np.testing.assert_array_equal(got_label.numpy(), np.asarray(want_label))

    want = np.asarray(jax.jit(jax_make_serve_fn(cfg, jparams, jstats))(request))
    got = make_serve_fn(pcfg, pparams, device="cpu")(request)
    assert tuple(got.shape) == (2, 48, 64) and str(got.dtype) == "torch.int32"
    agree = float((got.numpy() == want).mean())
    assert agree >= 0.999, agree


def test_evaluate_hist_matches_jax(setup):
    cfg, pcfg, (jparams, jstats), pparams = setup
    jds = jax_get_dataset("synthetic_shifted", cfg.data, "val")
    ds = get_dataset("synthetic_shifted", pcfg.data, "val")
    assert len(ds) == 3  # batch 2: the second batch is padded with one ignored copy
    jmiou, jhist, _ = jax_evaluate((jparams, jstats), cfg, dataset=jds, max_batches=2,
                                   print_table=False, num_workers=0)
    miou, hist, table = evaluate(pparams, pcfg, dataset=ds, max_batches=2,
                                 print_table=False, device="cpu")
    assert hist.dtype == np.int64
    np.testing.assert_array_equal(hist, jhist)
    n_valid = sum(int((ds[i]["label"] != 0).sum()) for i in range(3))  # raw 0 = void
    assert hist.sum() == n_valid
    assert miou == jmiou and "mIoU" in table
