"""The port's MCD step under spatial partitioning against the JAX package's
``make_mesh(spatial=4)`` step, float64 on both sides.

The setup of ``tests/test_sharding.py::test_spatial_sharded_mcd_step_fp64_equality``:
drn_d_22, input_ch 3, 4 classes, SGD at lr 0.01 constant, ``num_k`` 2, a
global batch of 4 at H=32, W=16 (``xs``, ``ys``, ``xt`` from
``np.random.RandomState(0)``), JAX's initial state from ``jax.random.key(0)``
lifted to float64 (flax makes float32 parameters, which the JAX test's two
runs round alike after their update) and carried over by
``params_from_jax``. JAX runs one step on its (2, 4) (data x space) mesh
of the conftest's virtual CPU devices; the port runs it on 4 gloo CPU
ranks (one spawn) in two layouts: 1 data block x 4 row
blocks, where the deepest map keeps one row per block against dilation
4's halo of 4, and 2 data blocks x 2 row blocks. JAX is imported here only;
the ranks get numpy and torch tensors.

Bound (the JAX test's): each metric within 1e-9 x (1 + |JAX's|), each
parameter and BatchNorm statistic within 1e-9 of JAX's relative to its
leaf's largest magnitude. The ranks' replicas are bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_worker import Ranks
from _torch_parity import x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.parallel.mesh import batch_sharding, constrain_spatial, make_mesh, replicate
from mcseg_tpu.train.mcd import make_mcd_step as jax_make_mcd_step
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

SHAPE = (32, 16)
NCLASS = 4
REL = 1e-9
MODEL = dict(net="drn_d_22", input_ch=3, n_class=NCLASS, dtype="float64", s2d="on")
TRAIN = dict(lr=0.01, num_k=2, lr_schedule="constant", max_steps=100)
LAYOUTS = {"1x4": 4, "2x2": 2}  # data blocks x row blocks of 4 ranks: the row extent


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.RandomState(0)
    xs = rng.rand(4, *SHAPE, 3)
    ys = rng.randint(0, NCLASS, size=(4, *SHAPE))
    xt = rng.rand(4, *SHAPE, 3)
    with x64():
        mcfg, tcfg = JaxModelConfig(**MODEL), JaxTrainConfig(**TRAIN)
        state, tx_g, tx_f = jax_create_train_state(mcfg, tcfg, jax.random.key(0),
                                                   img_shape=SHAPE)
        # flax initializes float32 parameters; the oracle updates float64 ones
        p64, stats64 = _np_tree(state.params), _np_tree(state.batch_stats)
        state = state.replace(
            params=jax.tree.map(jnp.asarray, p64),
            batch_stats=jax.tree.map(jnp.asarray, stats64),
            opt_g=tx_g.init(jax.tree.map(jnp.asarray, p64["G"])),
            opt_f=tx_f.init(jax.tree.map(jnp.asarray, {"F1": p64["F1"], "F2": p64["F2"]})))
        params = params_from_jax(p64, stats64)
        jobs = [("spatial_step", dict(space=s, params=params, model_cfg=MODEL, train_cfg=TRAIN,
                                      xs=xs, ys=ys, xt=xt)) for s in LAYOUTS.values()]
        ranks = Ranks(jobs, world=4)  # in the background while JAX runs
        inner = jax_make_mcd_step(*jax_get_models(mcfg), tx_g, tx_f, tcfg)
        mesh = make_mesh(spatial=4)

        @jax.jit
        def sp_step(state, xs, ys, xt):
            return inner(state, constrain_spatial(mesh, xs), constrain_spatial(mesh, ys),
                         constrain_spatial(mesh, xt))

        put = lambda x: jax.device_put(x, batch_sharding(mesh))  # noqa: E731
        s8, m8 = sp_step(replicate(mesh, state), put(xs), put(ys), put(xt))
        jax_out = {"metrics": {k: float(v) for k, v in m8.items()
                               if np.asarray(v).dtype.kind == "f"},
                   "params": _np_tree(s8.params), "stats": _np_tree(s8.batch_stats)}
    return {"jax": jax_out, "ranks": ranks.results()}


def _max_rel(got, want):
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)),
                        got, want)
    return max(jax.tree.leaves(errs))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_mcd_step_equals_jax_mesh_step(runs, layout):
    job = list(LAYOUTS).index(layout)
    want = runs["jax"]
    for rank, results in enumerate(runs["ranks"]):
        got = results[job]
        for k, r in want["metrics"].items():
            a = got["metrics"][k]
            assert abs(a - r) <= REL * (1 + abs(r)), (layout, rank, k, a, r)
        p, s = params_to_jax(got["params"])
        assert _max_rel(_np_tree(p), want["params"]) <= REL, (layout, rank)
        assert _max_rel(_np_tree(s["G"]), want["stats"]["G"]) <= REL, (layout, rank)
    first = runs["ranks"][0][job]["params"]
    for results in runs["ranks"][1:]:
        for name, sd in results[job]["params"].items():
            assert all(torch.equal(v, first[name][k]) for k, v in sd.items()), (layout, name)
