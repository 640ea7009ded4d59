"""Scoring a multitask checkpoint: the port's depth metrics, boundary match
counts, tester and serving against the JAX package's
(``eval/depth_metrics.py``, ``eval/tester.py`` ``boundary_match_sums`` /
``make_eval_step`` / ``evaluate``, ``eval/serving.py`` ``with_depth``).

``depth_metric_sums`` in float64 within 1e-12 (invalid targets and
non-positive predictions included); ``boundary_match_sums`` counts equal.
The tester and serving: drn_d_14, RGB (input_ch 3, so that both sides feed
the trunk the same normalized input), 40 classes, 64x48, float64 on both
sides, batch 2 over 3 ``synthetic_shifted`` val samples (the tail batch is
padded: its labels are ignored and its depth zeroed, so it adds nothing),
with depth and boundary heads. The IoU table with its depth and boundary
lines is the same text on both sides; the served depth map within 1e-6
relative (float32 out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_params_jax_layout, x64
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.data.datasets import get_dataset as jax_get_dataset
from mcseg_tpu.eval import depth_metrics as jax_depth_metrics
from mcseg_tpu.eval.serving import make_serve_fn as jax_make_serve_fn
from mcseg_tpu.eval.tester import boundary_match_sums as jax_boundary_match_sums
from mcseg_tpu.eval.tester import evaluate as jax_evaluate
from mcseg_tpu_torch.core.config import ExperimentConfig, ModelConfig
from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
from mcseg_tpu_torch.eval import depth_metrics
from mcseg_tpu_torch.eval.serving import make_serve_fn
from mcseg_tpu_torch.eval.tester import boundary_match_sums, evaluate
from mcseg_tpu_torch.models.factory import init_aux_heads
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def test_depth_metric_sums_match_jax_fp64():
    rng = np.random.RandomState(0)
    target = rng.uniform(0.2, 8.0, (3, 20, 28))
    target[0, :4] = 0.0
    target[1, 5:7] = np.nan
    target[2, :, :3] = 5e-4  # below min_depth
    pred = target * rng.uniform(0.7, 1.4, target.shape)
    pred[np.isnan(pred)] = 1.0
    pred[2, 10:12] = -rng.uniform(0.1, 1.0, (2, 28))  # non-positive: delta misses
    pred[2, 12:14] = 0.0
    with x64():
        want = {k: float(v) for k, v in jax_depth_metrics.depth_metric_sums(
            jnp.asarray(pred[..., None]), jnp.asarray(target)).items()}
    got = {k: float(v) for k, v in depth_metrics.depth_metric_sums(
        torch.from_numpy(pred[:, None]), torch.from_numpy(target)).items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    assert got["n"] < target.size and got["sdelta"] < got["n"]
    assert depth_metrics.finalize_depth_metrics(got) == pytest.approx(
        jax_depth_metrics.finalize_depth_metrics(want), rel=1e-12)


@pytest.mark.parametrize("tol", [0, 2])
def test_boundary_match_sums_equal_jax(tol):
    rng = np.random.RandomState(1)
    label = rng.randint(0, 4, (2, 6, 8)).repeat(4, 1).repeat(4, 2)
    label[0, :5, :9] = 255
    logits = rng.randn(2, 24, 32, 1)
    want = jax_boundary_match_sums(jnp.asarray(logits, jnp.float32), jnp.asarray(label), tol)
    got = boundary_match_sums(torch.from_numpy(logits).float().permute(0, 3, 1, 2),
                              torch.from_numpy(label), tol)
    assert got.keys() == want.keys()
    for k in want:
        assert int(got[k]) == int(want[k]), k
    assert int(got["tp_tol_p"]) >= int(got["tp"]) > 0


@pytest.fixture(scope="module")
def setup():
    cfg = JaxExperimentConfig(
        model=JaxModelConfig(net="drn_d_14", input_ch=3, n_class=40, dtype="float64"),
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic_shifted",
                           batch_size=2, test_img_shape=(64, 48), input_ch=3, max_samples=3))
    params, stats = port_params_jax_layout(cfg.model, img_hw=(48, 64), seed=3)
    pcfg = ExperimentConfig.from_dict(cfg.to_dict())
    aux, _ = params_to_jax(init_aux_heads(ModelConfig.from_dict(cfg.model.to_dict()),
                                          ("D", "B"), torch.Generator().manual_seed(4)))
    aux["D"]["depth"]["bias"] = np.full((1,), 3.0, np.float32)  # depth near the scene's
    params.update(aux)
    return cfg, pcfg, params, stats


def test_evaluate_depth_and_boundary_lines_match_jax(setup):
    cfg, pcfg, params, stats = setup
    with x64():
        jp, js = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        _, jhist, jtable = jax_evaluate((jp, js), cfg, dataset=jax_get_dataset(
            "synthetic_shifted", cfg.data, "val"), print_table=False, num_workers=0)
    ds = get_dataset("synthetic_shifted", pcfg.data, "val")
    assert len(ds) == 3  # the second batch is padded
    _, hist, table = evaluate(params_from_jax(params, stats), pcfg, dataset=ds,
                              print_table=False, device="cpu")
    np.testing.assert_array_equal(hist, jhist)
    aux_lines = [ln for ln in table.splitlines() if ln.startswith(("depth:", "boundary"))]
    assert [ln.split(":")[0] for ln in aux_lines] == [
        "depth", "boundary (tol=2px)", "boundary (strict)"]
    assert table == jtable
    # without the auxiliary heads the table ends at the IoU lines
    plain = {k: v for k, v in params_from_jax(params, stats).items() if k not in ("D", "B")}
    _, _, table_plain = evaluate(plain, pcfg, dataset=ds, print_table=False, device="cpu")
    assert table_plain == table.split("\ndepth:")[0]


def test_serve_with_depth_matches_jax(setup):
    cfg, pcfg, params, stats = setup
    raw = stack_samples(get_dataset("synthetic_shifted", pcfg.data, "val"), [0, 1])
    request = {"image": raw["image"], "depth": raw["depth"]}
    with x64():
        jp, js = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        want_pred, want_depth = jax.jit(jax_make_serve_fn(cfg, jp, js, with_depth=True))(
            {k: jnp.asarray(v) for k, v in request.items()})
    pparams = params_from_jax(params, stats)
    pred, depth = make_serve_fn(pcfg, pparams, device="cpu", with_depth=True)(request)
    assert depth.dtype == torch.float32 and tuple(depth.shape) == (2, 48, 64)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(want_pred))
    np.testing.assert_allclose(depth.numpy(), np.asarray(want_depth), rtol=1e-6, atol=0)
    assert torch.equal(make_serve_fn(pcfg, pparams, device="cpu")(request), pred)
    no_d = {k: v for k, v in pparams.items() if k != "D"}
    with pytest.raises(ValueError, match="no 'D' depth-head subtree"):
        make_serve_fn(pcfg, no_d, device="cpu", with_depth=True)
