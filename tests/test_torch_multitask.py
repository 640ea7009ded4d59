"""The port's multitask trainer against the JAX package's
(``mcseg_tpu/train/multitask.py``, ``losses/seg.py``, ``models/heads.py``,
``ops/preprocess.py`` with ``with_depth``), in float64 on both sides.

Losses and heads: ``boundary_targets_from_labels`` bit-equal;
``balanced_bce_2d`` and ``berhu_loss`` (values and input gradients, an
invalid-depth region and a tie in berHu's max included) and both auxiliary
heads in both upsample modes within 1e-12.

Steps: drn_d_14, input_ch 6, 5 classes, batch 2, 24x16, ``convt`` heads,
SGD with momentum 0.9 and weight decay 1e-3, the poly lr over 8 steps,
``num_k`` 2, depth weight 0.5 and boundary weight 1.0 (both heads live).
Source labels are 4x4 blocks (so the boundary targets have edges and
interiors) with an ignore region; source depth has a region that is 0 and
one that is NaN. Both sides start from the same weights in the JAX layout
(G, F1, F2 from ``_torch_parity.port_params_jax_layout``, D and B from the
port's seeded initializer). Bound: every metric, every parameter of G, F1,
F2, D and B and every BN running mean and variance within 1e-9 of the JAX
value, relative to the leaf's largest magnitude, after 1 and after 3
iterations (the MCD iteration's own test holds the same bound). In step B
JAX's optax update moves D and B by weight decay and momentum alone; the
port must give them zero gradients for the same move, or they drift by
1e-4 or more after the first iteration.

Train preprocess with depth: JAX's draws fed to the port, both geometry
branches, flips on and off. Labels bit-equal; the depth plane within 1e-6
relative (float32; the port lerps two taps, JAX multiplies by a two-tap
matrix, or both resize with an antialiased triangle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_train_draws, port_params_jax_layout, x64
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.losses import seg as jax_seg
from mcseg_tpu.models.factory import get_models as jax_get_models
from mcseg_tpu.models.heads import BoundaryDetector as JaxBoundaryDetector
from mcseg_tpu.models.heads import DepthRegressor as JaxDepthRegressor
from mcseg_tpu.ops.preprocess import make_train_preprocess as jax_make_train_preprocess
from mcseg_tpu.train.multitask import init_multitask_state as jax_init_multitask_state
from mcseg_tpu.train.multitask import make_multitask_mcd_step as jax_make_multitask_mcd_step
from mcseg_tpu.train.multitask import (
    make_multitask_source_step as jax_make_multitask_source_step)
from mcseg_tpu.train.optim import get_optimizer as jax_get_optimizer
from mcseg_tpu.train.state import MCDTrainState as JaxMCDTrainState
from mcseg_tpu_torch.core.config import DataConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
from mcseg_tpu_torch.losses import seg
from mcseg_tpu_torch.models.factory import get_aux_heads, init_aux_heads
from mcseg_tpu_torch.models.heads import BoundaryDetector, DepthRegressor
from mcseg_tpu_torch.ops.preprocess import make_train_preprocess, pre_crop_canvas
from mcseg_tpu_torch.train.multitask import (
    make_multitask_mcd_step, make_multitask_source_step)
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

B, H, W, NC = 2, 24, 16, 5
REL = 1e-9
STEPS = 3
W_D, W_B = 0.5, 1.0
TCFG = dict(opt="sgd", lr=0.05, momentum=0.9, weight_decay=1e-3, num_k=2, d_loss="diff",
            lr_schedule="poly", lr_power=0.9, max_steps=8)


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def _tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _max_rel_err(got_tree, want_tree):
    errs = jax.tree.map(lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)),
                        got_tree, want_tree)
    return max(jax.tree.leaves(errs))


def _block_labels(rng, b=B, h=H, w=W, block=4):
    y = rng.randint(0, NC, (b, h // block, w // block)).repeat(block, 1).repeat(block, 2)
    y[0, :3, :5] = 255  # an ignore region
    return y


def _depth(rng, b=B, h=H, w=W):
    d = rng.uniform(0.5, 6.0, (b, h, w))
    d[0, -4:, :6] = 0.0  # no reading
    d[1, :2, -3:] = np.nan  # invalid
    return d


# ---- losses and heads ----------------------------------------------------

def test_boundary_targets_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    y = _block_labels(rng, 3, 20, 28)
    y[1, 5:9, 7:11] = 255
    y[2] = rng.randint(0, 3, (20, 28))  # single-pixel regions
    want_t, want_v = jax_seg.boundary_targets_from_labels(jnp.asarray(y))
    got_t, got_v = seg.boundary_targets_from_labels(torch.from_numpy(y))
    assert got_t.dtype == torch.float32 and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert 0 < float(got_t.mean()) < 1


def test_balanced_bce_matches_jax_fp64():
    rng = np.random.RandomState(1)
    y = _block_labels(rng)
    logits = rng.randn(B, H, W, 1) * 2
    with x64():
        tgt, valid = jax_seg.boundary_targets_from_labels(jnp.asarray(y))
        want, want_grad = jax.value_and_grad(
            lambda x: jax_seg.balanced_bce_2d(x, tgt, valid))(jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    got = seg.balanced_bce_2d(x, *seg.boundary_targets_from_labels(torch.from_numpy(y)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12, atol=0)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-12 * np.abs(want_grad).max())


@pytest.mark.parametrize("tie", [False, True], ids=["no_tie", "tied_max"])
def test_berhu_matches_jax_fp64_gradient_through_c(tie):
    """Value and gradient wrt the prediction, with invalid pixels (0, NaN)
    and, in one case, the largest error reached at two pixels: JAX's max
    splits its gradient evenly between them, and so must the port's."""
    rng = np.random.RandomState(2)
    target = _depth(rng)
    pred = target + rng.randn(B, H, W) * 0.3
    pred[np.isnan(pred)] = 1.0
    if tie:
        pred[0, 5, 5] = target[0, 5, 5] + 9.0
        pred[1, 7, 3] = target[1, 7, 3] - 9.0
    with x64():
        want, want_grad = jax.value_and_grad(
            lambda p: jax_seg.berhu_loss(p, jnp.asarray(target)))(jnp.asarray(pred[..., None]))
    p = torch.from_numpy(pred[:, None]).requires_grad_(True)
    got = seg.berhu_loss(p, torch.from_numpy(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-12, atol=0)
    g = p.grad[:, 0].numpy()
    np.testing.assert_allclose(g, np.asarray(want_grad)[..., 0], rtol=0,
                               atol=1e-12 * np.abs(want_grad).max())
    assert np.all(g[~(np.isfinite(target) & (target > 0))] == 0)


@pytest.mark.parametrize("mode", ["convt", "resize"])
@pytest.mark.parametrize("name", ["D", "B"])
def test_aux_head_matches_flax_fp64(name, mode):
    jax_cls, cls = {"D": (JaxDepthRegressor, DepthRegressor),
                    "B": (JaxBoundaryDetector, BoundaryDetector)}[name]
    feat = np.random.RandomState(3).randn(B, 3, 2, 8)
    with x64():
        head = jax_cls(upsample=mode, dtype=jnp.float64)
        p = head.init(jax.random.key(4), jnp.asarray(feat), False)["params"]
        p = jax.tree.map(lambda a: np.asarray(a, np.float64) + 0.1, p)  # non-zero bias
        want = np.asarray(head.apply({"params": p}, jnp.asarray(feat), False))
    port = params_from_jax({"G": {}, "F1": {}, "F2": {}, name: p}, {})[name]
    ours = cls(8, upsample=mode).double()
    ours.load_state_dict(port)
    got = ours(_nchw(feat)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (B, 24, 16, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_aux_heads_bf16_compute_and_float32_out():
    head = DepthRegressor(16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        conv_out = head.conv(torch.randn(1, 16, 2, 3))
        out = head(torch.randn(1, 16, 2, 3))
    assert conv_out.dtype == torch.bfloat16 and out.dtype == torch.float32
    assert head.double()(torch.randn(1, 16, 2, 3, dtype=torch.float64)).dtype == torch.float64


def test_late_fusion_refused_as_jax_fails():
    late = dict(net="drn_d_14", input_ch=6, n_class=NC, fusion="late")
    with pytest.raises(ValueError, match="--fusion late"):
        get_aux_heads(ModelConfig(**late), ("D",))
    assert get_aux_heads(ModelConfig(**late), ()) == {}  # the other trainers are unaffected
    with pytest.raises(AttributeError):  # flax's depth head gets the (rgb, hha) pair
        jax.eval_shape(lambda k: jax_init_multitask_state(
            JaxModelConfig(**late), JaxTrainConfig(), k, img_shape=(16, 16))[0],
            jax.random.key(0))


# ---- the steps -----------------------------------------------------------

def _mcfg(jax_side, **kw):
    cls = JaxModelConfig if jax_side else ModelConfig
    return cls(net="drn_d_14", input_ch=6, n_class=NC, dtype="float64", upsample="convt", **kw)


@pytest.fixture(scope="module")
def start():
    """Initial weights in the JAX layout (G, F1, F2, D, B) and the batches."""
    params, stats = port_params_jax_layout(_mcfg(True), img_hw=(H, W), seed=7)
    aux, _ = params_to_jax(init_aux_heads(_mcfg(False), ("D", "B"),
                                          torch.Generator().manual_seed(8)))
    rng = np.random.RandomState(9)
    for k in ("D", "B"):
        name = "depth" if k == "D" else "boundary"
        aux[k][name]["bias"] = rng.normal(1.0, 0.1, (1,)).astype(np.float32)
    params.update(aux)
    batches = [(rng.randn(B, H, W, 6), _block_labels(rng), _depth(rng), rng.randn(B, H, W, 6))
               for _ in range(STEPS)]
    return _tree_np(params), _tree_np(stats), batches


def _jax_state(params, stats, tcfg):
    tx_g = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
    tx_f = jax_get_optimizer("sgd", tcfg.lr, tcfg.momentum, tcfg.weight_decay)
    p = jax.tree.map(jnp.asarray, params)
    state = JaxMCDTrainState(
        step=jnp.zeros((), jnp.int32), params=p,
        batch_stats={"G": jax.tree.map(jnp.asarray, stats["G"]), "F1": {}, "F2": {}},
        opt_g=tx_g.init(p["G"]), opt_f=tx_f.init({k: p[k] for k in ("F1", "F2", "D", "B")}),
        rng=jax.random.key(1))
    return state, tx_g, tx_f


def _jax_trajectory(start, mcd):
    params, stats, batches = start
    mcfg = _mcfg(True, method="MCD" if mcd else "source")
    tcfg = JaxTrainConfig(**TCFG)
    traj = []
    with x64():
        state, tx_g, tx_f = _jax_state(params, stats, tcfg)
        heads = dict(b_head=JaxBoundaryDetector(upsample="convt", dtype=jnp.float64),
                     boundary_weight=W_B)
        d_head = JaxDepthRegressor(upsample="convt", dtype=jnp.float64)
        make = jax_make_multitask_mcd_step if mcd else jax_make_multitask_source_step
        step = jax.jit(make(*jax_get_models(mcfg), d_head, tx_g, tx_f, tcfg, W_D, **heads))
        for xs, ys, ds, xt in batches:
            args = (xs, ys, ds, xt) if mcd else (xs, ys, ds)
            state, metrics = step(state, *map(jnp.asarray, args))
            traj.append({"metrics": {k: float(v) for k, v in metrics.items()},
                         "params": _tree_np(state.params),
                         "stats": _tree_np(state.batch_stats["G"])})
    return traj


@pytest.fixture(scope="module")
def jax_mcd(start):
    return _jax_trajectory(start, mcd=True)


@pytest.fixture(scope="module")
def jax_source(start):
    return _jax_trajectory(start, mcd=False)


def _port_trajectory(start, mcd):
    """The port's state after each of the STEPS iterations, as ``_jax_trajectory``
    records JAX's (the port's parameters in the JAX layout)."""
    params, stats, batches = start
    state = create_train_state(_mcfg(False, method="MCD" if mcd else "source"),
                               TrainConfig(**TCFG), device="cpu",
                               params=params_from_jax(params, stats), aux_heads=("D", "B"))
    make = make_multitask_mcd_step if mcd else make_multitask_source_step
    step = make(TrainConfig(**TCFG), W_D, W_B, torch.float64)
    traj = []
    for xs, ys, ds, xt in batches:
        args = (_nchw(xs), torch.from_numpy(ys), torch.from_numpy(ds))
        m = step(state, *args, _nchw(xt)) if mcd else step(state, *args)
        p, s = params_to_jax(state.params())
        traj.append({"metrics": {k: float(v) for k, v in m.items()}, "params": p,
                     "stats": s["G"], "step": state.step})
    return traj


@pytest.fixture(scope="module")
def port_mcd(start):
    return _port_trajectory(start, mcd=True)


@pytest.fixture(scope="module")
def port_source(start):
    return _port_trajectory(start, mcd=False)


def _check_against(got, ref, n):
    """Iteration ``n``'s state and every metric up to it against JAX's."""
    assert got[n - 1]["step"] == n
    for g, r in zip(got[:n], ref[:n]):
        assert g["metrics"].keys() == r["metrics"].keys()
        for k, want in r["metrics"].items():
            np.testing.assert_allclose(g["metrics"][k], want, rtol=REL, atol=0, err_msg=k)
    p, want = got[n - 1]["params"], ref[n - 1]["params"]
    assert sorted(p) == ["B", "D", "F1", "F2", "G"]
    assert jax.tree.structure(p) == jax.tree.structure(want)
    for name in p:  # G, F1, F2 and both auxiliary heads
        assert _max_rel_err(p[name], want[name]) < REL, name
    assert _max_rel_err(got[n - 1]["stats"], ref[n - 1]["stats"]) < REL  # running mean, var


@pytest.mark.parametrize("n", [1, STEPS], ids=["one_iteration", "poly_lr_trajectory"])
def test_multitask_mcd_step_matches_jax_fp64(jax_mcd, port_mcd, n):
    assert set(port_mcd[0]["metrics"]) == {"loss_source", "loss_seg", "loss_depth", "loss_b",
                                           "loss_dis", "lr", "loss_boundary"}
    _check_against(port_mcd, jax_mcd, n)


@pytest.mark.parametrize("n", [1, STEPS], ids=["one_step", "poly_lr_trajectory"])
def test_multitask_source_step_matches_jax_fp64(jax_source, port_source, n):
    assert set(port_source[0]["metrics"]) == {"loss", "loss_seg", "loss_depth", "lr",
                                              "loss_boundary"}
    _check_against(port_source, jax_source, n)


def test_depth_head_only_without_boundary_weight():
    """boundary_weight 0: no B head, no loss_boundary, as in JAX."""
    cfg = _mcfg(False)
    state = create_train_state(cfg, TrainConfig(**TCFG), device="cpu", aux_heads=("D",))
    assert state.b is None and sorted(state.params()) == ["D", "F1", "F2", "G"]
    rng = np.random.RandomState(10)
    m = make_multitask_source_step(TrainConfig(**TCFG), W_D, 0.0, torch.float64)(
        state, _nchw(rng.randn(B, H, W, 6)), torch.from_numpy(_block_labels(rng)),
        torch.from_numpy(_depth(rng)))
    assert set(m) == {"loss", "loss_seg", "loss_depth", "lr"}
    np.testing.assert_allclose(float(m["loss"]), float(m["loss_seg"]) + W_D * float(m["loss_depth"]),
                               rtol=1e-12)


# ---- train preprocess with depth ----------------------------------------

GEOMETRIES = {"upscale": ((64, 48), True), "resize_then_crop": ((96, 72), True),
              "no_crop": ((96, 72), False)}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("random_flip", [True, False])
def test_train_preprocess_depth_plane_matches_jax(geometry, random_flip):
    decode, crop = GEOMETRIES[geometry]
    raw = stack_samples(get_dataset("synthetic", DataConfig(train_img_shape=decode,
                                                            max_samples=3), "train"), range(3))
    jcfg = JaxDataConfig(src_dataset="synthetic", train_img_shape=(64, 48), input_ch=3,
                         random_crop=crop, random_flip=random_flip)
    pcfg = DataConfig.from_dict(jcfg.to_dict())
    pre, target = pre_crop_canvas(pcfg)
    key = jax.random.key(11)
    want_img, want_lbl, want_d = jax.jit(jax_make_train_preprocess(jcfg, with_depth=True))(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    draws = jax_train_draws(key, 3, pre, target, crop, random_flip)
    got_img, got_lbl, got_d = make_train_preprocess(pcfg, with_depth=True)(
        {k: torch.as_tensor(v) for k, v in raw.items()}, *draws)
    assert got_d.dtype == torch.float32 and tuple(got_d.shape) == (3, 48, 64)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    want_d = np.asarray(want_d)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    if random_flip:
        assert 0 < int(draws[2].sum()) < 3  # a mixed flip pattern
