"""Shared helpers of the JAX-vs-port parity tests (tests/test_torch_*.py):
seeded JAX parameters with non-trivial BatchNorm, a JAX float64 block, and
the train preprocess's random draws as JAX makes them."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mcseg_tpu.models.factory import init_models as jax_init_models


@contextlib.contextmanager
def x64():
    """JAX float64 for the duration of the block (the fp64 oracles)."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _randomize_bn(params, stats, rng):
    """BN scale/bias/mean/var drawn away from the identity (init leaves BN
    a no-op, which would hide a wrong mapping of the statistics)."""
    for k, v in params.items():
        if isinstance(v, dict):
            if "scale" in v:
                v["scale"] = rng.uniform(0.75, 1.25, v["scale"].shape).astype(np.float32)
                v["bias"] = rng.normal(0.0, 0.1, v["bias"].shape).astype(np.float32)
                stats[k]["mean"] = rng.normal(0.0, 0.1, v["scale"].shape).astype(np.float32)
                stats[k]["var"] = rng.uniform(0.75, 1.25, v["scale"].shape).astype(np.float32)
            else:
                _randomize_bn(v, stats.get(k, {}), rng)


def jax_params(model_cfg, img_hw=(48, 64), seed=0):
    """(params, batch_stats) as nested dicts of numpy arrays: the JAX
    initializer's tree, BN statistics randomized, head biases non-zero."""
    # the tree does not depend on the compute dtype; float32 init avoids
    # float64 outside an x64 block
    v = jax_init_models(dataclasses.replace(model_cfg, dtype="float32"),
                        jax.random.key(seed), img_shape=img_hw)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    params = {k: dict(p) for k, p in params.items()}
    rng = np.random.RandomState(seed)
    _randomize_bn(params["G"], stats["G"], rng)
    for head in ("F1", "F2"):
        score = params[head]["score"]
        score["bias"] = rng.normal(0.0, 0.1, score["bias"].shape).astype(np.float32)
    return params, stats


def port_params_jax_layout(model_cfg, img_hw=(48, 64), seed=0):
    """(params, batch_stats) in the JAX layout, as ``jax_params`` gives,
    made from the port's seeded initializer instead of JAX's (whose
    forward costs seconds of XLA compiles per trunk). The tree is held to
    the JAX initializer's names and shapes by ``jax.eval_shape``, which
    compiles nothing; BN statistics and head biases are randomized."""
    import torch

    from mcseg_tpu_torch.core.config import ModelConfig as PortModelConfig
    from mcseg_tpu_torch.models.factory import init_models as port_init_models
    from mcseg_tpu_torch.utils.jax_weights import params_to_jax

    jcfg = dataclasses.replace(model_cfg, dtype="float32")
    want = jax.eval_shape(lambda k: jax_init_models(jcfg, k, img_shape=img_hw),
                          jax.random.key(seed))
    port = port_init_models(PortModelConfig.from_dict(jcfg.to_dict()),
                            torch.Generator().manual_seed(seed))
    params, stats = params_to_jax(port)
    for got, ref in ((params, want["params"]), (stats, want["batch_stats"])):
        got_shapes = jax.tree.map(np.shape, got)
        ref_shapes = jax.tree.map(lambda s: tuple(s.shape), ref)
        assert got_shapes == ref_shapes, "port tree differs from the JAX initializer's"
    rng = np.random.RandomState(seed)
    _randomize_bn(params["G"], stats["G"], rng)
    for head in ("F1", "F2"):
        for path, bias in _score_biases(params[head]):
            path["bias"] = rng.normal(0.0, 0.1, bias.shape).astype(np.float32)
    return params, stats


def _score_biases(tree):
    """(dict holding a score conv's 'bias', the bias) for every head in the
    F tree (one, or two under late fusion)."""
    if "score" in tree:
        return [(tree["score"], tree["score"]["bias"])]
    return [pair for sub in tree.values() if isinstance(sub, dict)
            for pair in _score_biases(sub)]


def jax_train_draws(key, b, pre, target, random_crop, random_flip):
    """The crop offsets and flips ``make_train_preprocess`` of the JAX
    package draws from ``key`` (``ops/preprocess.py:288-289, 313-315,
    328``), as int32 torch tensors for the port's preprocess."""
    import torch

    if random_crop and pre != target:
        k_top, k_left, k_flip = jax.random.split(key, 3)
        tops = jax.random.randint(k_top, (b,), 0, pre[0] - target[0] + 1)
        lefts = jax.random.randint(k_left, (b,), 0, pre[1] - target[1] + 1)
    else:
        k_flip = key
        tops = lefts = jnp.zeros((b,), jnp.int32)
    flip = (jax.random.bernoulli(k_flip, 0.5, (b,)) if random_flip
            else jnp.zeros((b,), bool))
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int32)) for a in (tops, lefts, flip))
