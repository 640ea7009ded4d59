"""The port's source-only step against the JAX package's
``make_source_step``, in float64 on both sides.

drn_d_14, input_ch 6, 5 classes, batch 2, 24x16, ``convt`` heads, SGD with
momentum 0.9 and weight decay 1e-3, the poly lr over 8 steps (every step at
another lr). Both sides start from the same weights in the JAX layout (the
tree of JAX's initializer, BN statistics and head biases randomized:
``_torch_parity.port_params_jax_layout``), carried into the port by
``params_from_jax``; the port's state is compared in JAX's tree through
``params_to_jax``.

Bound: the loss, every parameter and BN running mean and variance within
1e-9 of the JAX value, relative to that leaf's largest magnitude, after one
step and after a 5-step trajectory (the same bound as the MCD iteration's
test, ``tests/test_torch_mcd.py``). A slip of semantics (one head left
unsupervised, BN advanced twice, an lr off by one step) moves values by
1e-4 or more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import port_params_jax_layout, x64
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.source import make_source_step as jax_make_source_step
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import ModelConfig, TrainConfig
from mcseg_tpu_torch.train.source import make_source_step
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W, NC = 2, 24, 16, 5
REL = 1e-9
STEPS = 5
TCFG = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, lr_schedule="poly",
            lr_power=0.9, max_steps=8)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        y = rng.randint(0, NC, (B, H, W))
        y[1, -2:] = 255  # ignored pixels on every step
        out.append((rng.randn(B, H, W, 6), y))
    return out


@pytest.fixture(scope="module")
def jax_run():
    mcfg = JaxModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64",
                          upsample="convt", method="source")
    params, stats = port_params_jax_layout(mcfg, img_hw=(H, W), seed=5)
    params, stats = _tree_np(params), _tree_np(stats)
    batches = _batches(STEPS)
    tcfg = JaxTrainConfig(**TCFG)
    traj = []
    with x64():
        tx_g = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        tx_f = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
        p = jax.tree.map(jnp.asarray, params)
        state = JaxMCDTrainState(
            step=jnp.zeros((), jnp.int32), params=p,
            batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
            opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({"F1": p["F1"], "F2": p["F2"]}),
            rng=jax.random.key(1))
        step = jax.jit(jax_make_source_step(*jax_get_models(mcfg), tx_g, tx_f, tcfg))
        for x, y in batches:
            state, metrics = step(state, jnp.asarray(x), jnp.asarray(y))
            traj.append({"metrics": {k: float(v) for k, v in metrics.items()},
                         "params": _tree_np(state.params),
                         "stats": _tree_np(state.batch_stats["G"])})
    return {"params": params, "stats": stats, "batches": batches, "traj": traj}


def _max_rel_err(got_tree, want_tree):
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


def _run_port(jax_run, n):
    mcfg = ModelConfig(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64",
                       upsample="convt", method="source")
    state = create_train_state(mcfg, TrainConfig(**TCFG), device="cpu",
                               params=params_from_jax(jax_run["params"], jax_run["stats"]))
    step = make_source_step(TrainConfig(**TCFG), torch.float64)
    metrics = []
    for x, y in jax_run["batches"][:n]:
        m = step(state, torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _check_against(state, metrics, ref):
    for k in ("loss", "lr"):
        np.testing.assert_allclose(metrics[k], ref["metrics"][k], rtol=REL, atol=0, err_msg=k)
    p, s = params_to_jax(state.params())
    assert jax.tree.structure(p) == jax.tree.structure(ref["params"])
    assert _max_rel_err(p, ref["params"]) < REL  # G, F1 and F2 all moved as in JAX
    assert _max_rel_err(s["G"], ref["stats"]) < REL  # running mean and var


def test_one_source_step_matches_jax_fp64(jax_run):
    state, (metrics,) = _run_port(jax_run, 1)
    assert state.step == 1 and set(metrics) == {"loss", "lr"}
    _check_against(state, metrics, jax_run["traj"][0])
    # both heads are supervised: F2 moved as far as F1
    for head in ("F1", "F2"):
        moved = state.params()[head]["score.weight"].numpy() - \
            jax_run["params"][head]["score"]["kernel"].transpose(3, 2, 0, 1)
        assert np.abs(moved).max() > 1e-4, head


def test_source_poly_lr_trajectory_matches_jax_fp64(jax_run):
    state, metrics = _run_port(jax_run, STEPS)
    lrs = [m["lr"] for m in metrics]
    assert len(set(lrs)) == STEPS and lrs == sorted(lrs, reverse=True)
    for m, ref in zip(metrics, jax_run["traj"]):
        for k in ("loss", "lr"):
            np.testing.assert_allclose(m[k], ref["metrics"][k], rtol=REL, atol=0, err_msg=k)
    _check_against(state, metrics[-1], jax_run["traj"][-1])
