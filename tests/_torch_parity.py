"""Shared helpers of the JAX-vs-port parity tests (tests/test_torch_*.py):
seeded JAX parameters with non-trivial BatchNorm, a JAX float64 block, the
train preprocess's random draws as JAX makes them, the dropout masks of
the JAX VGG trunk, the JAX FCN8s head lifted to float64, and the JAX
training loops fed the batches a port loop preprocessed."""

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
    compiles nothing; BN statistics and the biases of every conv that has
    one (the heads', and the VGG trunk's) are randomized."""
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
    for name in ("G", "F1", "F2"):
        for path, bias in _conv_biases(params[name]):
            path["bias"] = rng.normal(0.0, 0.1, bias.shape).astype(np.float32)
    return params, stats


def _conv_biases(tree):
    """(dict holding a conv's 'bias', the bias) for every conv of the tree
    that has one (DRN and PSP convs have none; BN biases are not convs')."""
    if "kernel" in tree and "bias" in tree:
        return [(tree, tree["bias"])]
    return [pair for sub in tree.values() if isinstance(sub, dict)
            for pair in _conv_biases(sub)]


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


class _Float64Jnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def lift_fcn8s_float32_cast(monkeypatch):
    """The JAX FCN8s head casts its three scores to exactly float32
    (``mcseg_tpu/models/fcn_vgg.py:123-125``), under the float64 oracle
    too, where the port's head casts to at least float32 and keeps float64.
    For a float64 comparison the JAX module reads ``jnp.float32`` as
    float64 (its ``param_dtype`` too, which applying given parameters does
    not read); nothing else of the module changes."""
    from mcseg_tpu.models import fcn_vgg

    monkeypatch.setattr(fcn_vgg, "jnp", _Float64Jnp())


def flax_vgg_dropout_masks(keys, shape):
    """The keep-masks that the JAX VGG trunk's two ``nn.Dropout(0.5)``
    layers draw in a train-mode forward with dropout rng ``key``, for each
    of ``keys`` in turn: NCHW bool torch tensors in call order (drop6,
    drop7, drop6, ...). ``shape`` is the NHWC activation's. A probe module
    with two unnamed Dropouts at its root has their scope paths
    (``Dropout_0``, ``Dropout_1``), so flax derives the same rngs and draws
    the same masks; call it with x64 set as the step that uses the masks
    (``bernoulli`` draws in the default float dtype)."""
    import flax.linen as nn
    import torch

    class _Probe(nn.Module):
        @nn.compact
        def __call__(self, x):
            return (nn.Dropout(0.5, deterministic=False)(x),
                    nn.Dropout(0.5, deterministic=False)(x))

    ones = jnp.ones(shape)
    return [torch.from_numpy(np.asarray(y) > 0).permute(0, 3, 1, 2)
            for k in keys for y in _Probe().apply({}, ones, rngs={"dropout": k})]


@contextlib.contextmanager
def recording_train_inputs(loops_module):
    """Within the block, every train preprocess that the port's
    ``loops_module`` builds records its outputs, as numpy arrays in call
    order, into the yielded list (source and target alternate per
    iteration)."""
    import pytest

    recorded = []
    build = loops_module.make_train_preprocess

    def recording(*args, **kwargs):
        pp = build(*args, **kwargs)

        def preprocess(*a):
            out = pp(*a)
            recorded.append([None if t is None else t.detach().cpu().numpy() for t in out])
            return out

        return preprocess

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loops_module, "make_train_preprocess", recording)
        yield recorded


@contextlib.contextmanager
def jax_loops_fed(recorded, pairs=True):
    """Within the block, the JAX package's training loops train on the
    batches ``recording_train_inputs`` recorded instead of decoding and
    preprocessing their own: the loops' input stream yields those batches
    (images as float64, sharded on the loop's mesh), as (source, target)
    pairs or, without ``pairs`` (the source-only loop), one by one, and
    their train preprocess passes a batch through. The port's preprocess makes float32
    (its kernel's output), JAX's float64 ones differ from it by float32
    rounding; fed the same batches, the loops' steps, schedules and
    bookkeeping are held to each other. JAX's modules stay as they are."""
    import pytest

    from mcseg_tpu.parallel.mesh import shard_batch
    from mcseg_tpu.train import loops as jax_loops

    def as_batch(out):
        img, label = out[0], out[1]
        batch = {"image": img.astype(np.float64),
                 "label": np.zeros(img.shape[:3], np.int32) if label is None else label}
        if len(out) > 2:
            batch["depth"] = out[2].astype(np.float64)
        return batch

    batches = ([(as_batch(s), as_batch(t)) for s, t in zip(recorded[::2], recorded[1::2])]
               if pairs else [as_batch(b) for b in recorded])

    def make_train_preprocess(cfg, with_depth=False, compute_dtype=None):
        keys = ("image", "label", "depth") if with_depth else ("image", "label")
        return lambda raw, key, remap_table=None: tuple(raw[k] for k in keys)

    def input_stream(dataset, mesh, cfg, start_epoch):
        if not pairs:
            return iter([shard_batch(mesh, b) for b in batches])
        return iter([(shard_batch(mesh, s), shard_batch(mesh, t)) for s, t in batches])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loops, "make_train_preprocess", make_train_preprocess)
        mp.setattr(jax_loops, "_input_stream", input_stream)
        yield
