"""The port's optimizers and lr schedules against the JAX package's.

Schedules: the port's float64 host functions against
``mcseg_tpu/train/optim.py`` under x64, to 1e-15 relative. Updates: three
steps of ``torch.optim.SGD`` / ``Adam`` (weight decay on, the lr changed
between steps through ``set_lr``) against the optax chains of
``get_optimizer`` with the injected lr, float64 on both sides, to 1e-13
relative (the same operations in a different order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import x64
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.optim import make_lr_schedule as jax_make_lr_schedule
from mcseg_tpu.train.optim import set_lr as jax_set_lr
from mcseg_tpu_torch.train.optim import get_optimizer, make_lr_schedule, set_lr
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


@pytest.mark.parametrize("kind", ["poly", "step", "constant"])
def test_schedules_match_jax(kind):
    steps = [0, 1, 7, 19, 20, 33, 59, 60, 61, 200]
    port = make_lr_schedule(kind, 0.05, 60, 0.9)
    with x64():
        ref = jax_make_lr_schedule(kind, 0.05, 60, 0.9)
        want = [float(ref(jnp.asarray(s))) for s in steps]
    got = [port(s) for s in steps]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    with pytest.raises(ValueError):
        make_lr_schedule("cosine", 0.05, 60)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_updates_match_optax(opt):
    rng = np.random.RandomState(0)
    w0 = {"a": rng.randn(4, 3), "b": rng.randn(5)}
    grads = [{k: rng.randn(*v.shape) for k, v in w0.items()} for _ in range(3)]
    lrs = [0.1, 0.07, 0.03]
    wd = 0.01

    with x64():
        tx = jax_get_optimizer(opt, lrs[0], 0.9, wd)
        params = jax.tree.map(jnp.asarray, w0)
        state = tx.init(params)
        for lr, g in zip(lrs, grads):
            state = jax_set_lr(state, jnp.asarray(lr))
            up, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
            params = optax.apply_updates(params, up)
        want = jax.tree.map(np.asarray, params)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    topt = get_optimizer(tparams.values(), opt, lrs[0], 0.9, wd)
    for lr, g in zip(lrs, grads):
        set_lr(topt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-13, atol=1e-15)
    with pytest.raises(ValueError):
        get_optimizer(tparams.values(), "lamb")
