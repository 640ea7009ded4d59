"""The port's losses against the JAX package's, in float64 on both sides.

``cross_entropy_2d`` (ignore 255, mean over valid pixels, 0 when every
pixel is ignored) and both discrepancies, values and gradients
(``jax.grad`` against ``torch.autograd``). The JAX logits are NHWC, the
port's NCHW. Both sides compute the same float64 sums in different orders:
1e-12 relative holds them (measured below 1e-15).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import x64
from mcseg_tpu.losses.discrepancy import get_prob_distance_criterion as jax_disc
from mcseg_tpu.losses.seg import cross_entropy_2d as jax_ce
from mcseg_tpu_torch.losses.discrepancy import get_prob_distance_criterion
from mcseg_tpu_torch.losses.seg import at_least_f32, cross_entropy_2d
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

RTOL = 1e-12


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _logits(seed, shape=(2, 7, 9, 5)):
    return np.random.RandomState(seed).randn(*shape) * 2.0


@pytest.mark.parametrize("ignored", ["none", "some", "all"])
def test_cross_entropy_matches_jax(ignored):
    rng = np.random.RandomState(1)
    logits = _logits(0)
    labels = rng.randint(0, 5, logits.shape[:3])
    if ignored == "some":
        labels[0, :3] = 255
        labels[1, :, 4] = 255
    elif ignored == "all":
        labels[:] = 255
    with x64():
        want, want_grad = jax.value_and_grad(jax_ce)(jnp.asarray(logits), jnp.asarray(labels))
    x = _nchw(logits).requires_grad_(True)
    got = cross_entropy_2d(x, torch.from_numpy(labels))
    got.backward()
    if ignored == "all":
        assert got.item() == 0.0 and float(want) == 0.0  # not NaN
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=0)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grad),
                               rtol=RTOL, atol=1e-17)


@pytest.mark.parametrize("name", ["diff", "symkl"])
def test_discrepancy_matches_jax(name):
    a, b = _logits(2), _logits(3)
    with x64():
        want, (ga, gb) = jax.value_and_grad(jax_disc(name), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
    ta, tb = _nchw(a).requires_grad_(True), _nchw(b).requires_grad_(True)
    got = get_prob_distance_criterion(name)(ta, tb)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=0)
    for t, w in ((ta, ga), (tb, gb)):
        np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=1e-10, atol=1e-17)


def test_loss_math_is_at_least_float32():
    x = torch.randn(2, 3, 4, 4).to(torch.bfloat16)
    assert at_least_f32(x).dtype == torch.float32
    assert at_least_f32(x.double()).dtype == torch.float64
    labels = torch.zeros(2, 4, 4, dtype=torch.int32)
    assert cross_entropy_2d(x, labels).dtype == torch.float32
    assert get_prob_distance_criterion("diff")(x, x).dtype == torch.float32
    with pytest.raises(ValueError):
        get_prob_distance_criterion("l2")
