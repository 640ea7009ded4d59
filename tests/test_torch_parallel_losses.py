"""BatchNorm and the losses over the global batch of a data-parallel group:
2 gloo ranks (one spawn for the module) against 1 process against the JAX
functions on the global batch, float64 on every side.

Batch 4, rank r holding rows 2r..2r+1, with inputs that tell a global
reduction from a per-rank one: rank 1's BatchNorm input is shifted and
scaled away from rank 0's, every ignored pixel of the cross-entropy and
every invalid pixel of the boundary loss sits in one rank's rows, and
berHu's largest error sits in rank 1's rows (its max feeds ``c`` and
the gradient).

Each rank's loss is the loss of the global batch. Its autograd computes the
gradient of the sum of the ranks' losses (the collectives' backward sums
over the ranks, as ``torch.distributed.nn``'s does), so a rank's input
gradient is ``world`` times its rows of the global gradient, and a
parameter's gradient summed over the ranks is ``world`` times the global
one: the training steps average the parameter gradients. Bounds: values
within 1e-12 and gradients within 1e-10 of JAX, relative to the largest
magnitude of each (the sums differ in order only; measured below 1e-14).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import losses_task, spawn
from _torch_parity import x64
from mcseg_tpu.losses.discrepancy import get_prob_distance_criterion as jax_disc
from mcseg_tpu.losses.seg import balanced_bce_2d as jax_bce
from mcseg_tpu.losses.seg import berhu_loss as jax_berhu
from mcseg_tpu.losses.seg import cross_entropy_2d as jax_ce
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, C, H, W, NC = 4, 8, 6, 5, 5
WORLD = 2
VALUE_REL, GRAD_REL = 1e-12, 1e-10


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(B, C, H, W)
    x[2:] = x[2:] * 3.0 + 2.0  # rank 1's statistics differ from rank 0's
    bn = (x, rng.randn(B, C, H, W), rng.uniform(0.5, 1.5, C), rng.normal(0, 0.2, C),
          rng.normal(0, 0.1, C), rng.uniform(0.75, 1.25, C))
    labels = rng.randint(0, NC, (B, H, W))
    labels[2:, :4] = 255  # every ignored pixel in rank 1's rows
    ce = (rng.randn(B, NC, H, W) * 2.0, labels)
    valid = np.ones((B, H, W), bool)
    valid[:2, :, :2] = False  # every invalid pixel in rank 0's rows
    bce = (rng.randn(B, H, W) * 2.0, (rng.rand(B, H, W) < 0.2).astype(np.float64), valid)
    depth = rng.uniform(0.5, 8.0, (B, H, W))
    depth[0, 0] = 0.0  # unsupervised pixels
    pred = depth[:, None] + rng.randn(B, 1, H, W) * 0.3
    pred[3, 0, 2, 2] += 9.0  # the largest error, in rank 1's rows
    disc = (rng.randn(B, NC, H, W) * 2.0, rng.randn(B, NC, H, W) * 2.0)
    return dict(batch_norm=bn, ce=ce, bce=bce, berhu=(pred, depth), disc=disc)


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)
    assert err <= rel, f"{what}: relative error {err:.3g} > {rel:g}"


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(inputs):
    """{"ranks": the two ranks' results, "one": one process's}."""
    ranks = [r[0] for r in spawn([("losses", inputs)], world=WORLD)]
    return {"ranks": ranks, "one": losses_task(None, **inputs)}


@pytest.fixture(scope="module")
def jax_ref(inputs):
    with x64():
        x, probe, weight, bias, rm, rv = inputs["batch_norm"]
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                          dtype=jnp.float64, param_dtype=jnp.float64)
        stats = {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}

        def bn_loss(xh, scale, b):
            y, upd = bn.apply({"params": {"scale": scale, "bias": b}, "batch_stats": stats},
                              xh, mutable=["batch_stats"])
            return (y * _nhwc(probe)).sum(), (y, upd["batch_stats"])

        (loss, (y, new_stats)), grads = jax.value_and_grad(bn_loss, argnums=(0, 1, 2),
                                                           has_aux=True)(
            _nhwc(x), jnp.asarray(weight), jnp.asarray(bias))
        out = {"bn": {"loss": loss, "y": _nchw(y), "dx": _nchw(grads[0]),
                      "dweight": grads[1], "dbias": grads[2],
                      "running_mean": new_stats["mean"], "running_var": new_stats["var"]}}
        logits, labels = inputs["ce"]
        v, g = jax.value_and_grad(jax_ce)(_nhwc(logits), jnp.asarray(labels))
        out["ce"] = (v, [_nchw(g)])
        logits, targets, valid = inputs["bce"]
        v, g = jax.value_and_grad(jax_bce)(jnp.asarray(logits), jnp.asarray(targets),
                                           jnp.asarray(valid))
        out["bce"] = (v, [np.asarray(g)])
        pred, depth = inputs["berhu"]
        v, g = jax.value_and_grad(jax_berhu)(_nhwc(pred), jnp.asarray(depth))
        out["berhu"] = (v, [_nchw(g)])
        a, b = inputs["disc"]
        for name in ("diff", "symkl"):
            v, (ga, gb) = jax.value_and_grad(jax_disc(name), argnums=(0, 1))(_nhwc(a), _nhwc(b))
            out[name] = (v, [_nchw(ga), _nchw(gb)])
        return jax.tree.map(np.asarray, out)


def _rows(ranks, get):
    """The ranks' rows of a per-row quantity, concatenated in rank order."""
    return np.concatenate([np.asarray(get(r)) for r in ranks])


def test_batch_norm_statistics_over_the_global_batch(runs, jax_ref):
    want = jax_ref["bn"]
    for tag, ranks in (("2 ranks", runs["ranks"]), ("1 rank", [runs["one"]])):
        world = len(ranks)
        _close(_rows(ranks, lambda r: r["bn"]["y"]), want["y"], VALUE_REL, f"{tag} y")
        for r in ranks:
            _close(r["bn"]["loss"], want["loss"], VALUE_REL, f"{tag} loss")
            for k in ("running_mean", "running_var"):
                _close(r["bn"][k], want[k], VALUE_REL, f"{tag} {k}")
        _close(_rows(ranks, lambda r: r["bn"]["dx"]) / world, want["dx"], GRAD_REL, f"{tag} dx")
        for k in ("dweight", "dbias"):
            total = sum(r["bn"][k] for r in ranks) / world
            _close(total, want[k], GRAD_REL, f"{tag} {k}")


@pytest.mark.parametrize("name", ["ce", "bce", "berhu", "diff", "symkl"])
def test_loss_over_the_global_batch(runs, jax_ref, name):
    """``ce``: the ignored pixels all in rank 1's rows; ``bce``: the invalid
    ones in rank 0's; ``berhu``: the max error in rank 1's."""
    want_value, want_grads = jax_ref[name]
    for tag, ranks in (("2 ranks", runs["ranks"]), ("1 rank", [runs["one"]])):
        world = len(ranks)
        for r in ranks:
            _close(r[name][0], want_value, VALUE_REL, f"{tag} {name} value")
        for i, want in enumerate(want_grads):
            got = _rows(ranks, lambda r: r[name][1][i]) / world
            _close(got, want, GRAD_REL, f"{tag} {name} grad {i}")


def test_a_per_rank_mean_would_differ(inputs, jax_ref):
    """The inputs tell the reductions apart: the mean of the ranks' own
    cross-entropies and berHu losses is far from the global one."""
    from mcseg_tpu_torch.losses.seg import berhu_loss, cross_entropy_2d

    logits, labels = inputs["ce"]
    pred, depth = inputs["berhu"]
    per_rank_ce = np.mean([cross_entropy_2d(torch.from_numpy(logits[s]),
                                            torch.from_numpy(labels[s])).item()
                           for s in (slice(0, 2), slice(2, 4))])
    per_rank_berhu = np.mean([berhu_loss(torch.from_numpy(pred[s]),
                                         torch.from_numpy(depth[s])).item()
                              for s in (slice(0, 2), slice(2, 4))])
    assert abs(per_rank_ce - float(jax_ref["ce"][0])) > 1e-3
    assert abs(per_rank_berhu - float(jax_ref["berhu"][0])) > 1e-3
