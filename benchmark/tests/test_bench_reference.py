"""The reference against the program on the CPU, at a tiny size.

Through the drivers' own code (set-up, the program's first iterations or
requests, the check), in float64, every number the check forms reads near
zero where the chaos of random weights leaves it room: the inputs to
float32 rounding, the first loss, the BatchNorm statistics after step A, the
median leaf's first gradient and change; the served class maps are the
reference's best.

Fed the same weights and raw planes, the reference's preprocess agrees with
the program's (labels equal; RGB to float32 rounding; HHA to the float32
arccos of a cosine near 1); fed the same preprocessed inputs, its MCD
iterations (a BasicBlock and a Bottleneck trunk) and its served logits
agree with the program's in float64: every leaf after the first
iteration and the logits to 1e-9, the losses of three iterations to 1e-8,
except the discrepancy after the first, to 1e-2 (at a batch of two the
Bottleneck trunk's third discrepancy moves by 1e-5 to 1e-3 with the CPU's
thread count alone); the control, computed in float8, does not. Together
they cover both training cells' iterations and the serve forward.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark.lib.scenes import generator, scenes
from benchmark.lib.weights import make_params
from benchmark.reference import preprocess as rp
from benchmark.reference.drn import build_models, set_precision
from benchmark.reference.mcd import MCD
from benchmark.reference.quant import FP8
from benchmark.tests._tiny import tiny_config, tiny_traffic

B, H, W = 2, 48, 64


@pytest.mark.parametrize("config,traffic", [
    ("tiny_d22", "mcd_train_b24_640x480.json"),
    ("tiny_d54_rgb", "mcd_train_b16_1024x512.json")])
def test_train_driver_agrees_float64(config, traffic):
    from benchmark.drivers.train import Run

    torch.set_num_threads(4)
    r = Run(tiny_config(config, "float64"), tiny_traffic(traffic), 2**33 + 5, "cpu")
    r.setup()
    r.free()
    n = r.check()
    assert n["input_gap"] < 1e-6 and n["label_mismatch"] == 0  # float32 preprocess
    assert n["loss_a_gap"] < 1e-5
    assert n["stats_a_diff"] < 1e-4
    assert n["grad_gap_median"] < 1e-3 and n["update1_gap_median"] < 1e-3
    if config == "tiny_d22":
        assert n["hha_gap"] < 1e-6


def test_serve_driver_agrees_float64():
    from benchmark.drivers.serve import Run

    r = Run(tiny_config("tiny_d22", "float64"), tiny_traffic("serve_b8_closed.json"),
            2**33 + 6, "cpu")
    r.setup()
    r.answers = [(i, r.request(i)) for i in range(3)]
    r.free()
    n = r.check()
    assert n["logit_gap"] == 0.0 and n["class_mismatch"] == 0.0


def _program_cfg(config, traffic, seed=5):
    from benchmark.drivers.train import program_config

    return program_config(config, traffic, seed)


def _pool(traffic, seed=5):
    sc = traffic["scene"]
    src = scenes(sc, B, 0.0, generator(seed, 2, device="cpu"))
    tgt = scenes(sc, B, 1.0, generator(seed, 3, device="cpu"), labels=False)
    return src, tgt


@pytest.mark.parametrize("config,traffic", [
    ("tiny_d22", "mcd_train_b24_640x480.json"),
    ("tiny_d54_rgb", "mcd_train_b16_1024x512.json")])
def test_train_preprocess_agrees(config, traffic):
    from mcseg_tpu_torch.ops.preprocess import make_train_preprocess, pre_crop_canvas
    from mcseg_tpu_torch.train.loops import _draws, augment_generator

    c, t = tiny_config(config), tiny_traffic(traffic)
    cfg = _program_cfg(c, t)
    src, _ = _pool(t)
    pre, target = pre_crop_canvas(cfg.data)
    assert pre == rp.canvas(target, t["train"]["crop_scale_min"])
    for it in range(4):
        gen = augment_generator(cfg.train.seed, it)
        ds = _draws(gen, B, pre, target, cfg, None)
        dt = _draws(gen, B, pre, target, cfg, None)
        (ts, ls, fs), (tt, lt, ft) = rp.draws(cfg.train.seed, it, B, target, pre)
        for got, want in zip(ds + dt, (ts, ls, fs, tt, lt, ft)):
            assert torch.equal(got.long(), want.long())
        x, y = make_train_preprocess(cfg.data, torch.float32)(src, *ds)
        xr, yr = rp.train_inputs(src, c["model"]["input_ch"],
                                 rp.label_table(c["label_map"], "cpu"), target, pre, ts, ls, fs)
        assert torch.equal(y.long(), yr)
        assert int((yr != 255).sum()) > 0
        err = (x.permute(0, 3, 1, 2) - xr).abs().amax(dim=(0, 2, 3))
        assert float(err[:3].max()) < 2e-5  # RGB: float32 rounding
        if c["model"]["input_ch"] == 6:
            # HHA's angle: arccos of a float32 cosine near 1 moves by up to
            # ~0.02 degrees per step of the cosine (1e-4 after /255/std)
            assert float(err[3:].max()) < 5e-4


def _models(model, params, dtype):
    mods = [m.to(dtype) for m in build_models(model)]
    for name, m in zip(("G", "F1", "F2"), mods):
        m.load_state_dict(params[name])
    return mods


@pytest.mark.parametrize("config,traffic", [
    ("tiny_d22", "mcd_train_b24_640x480.json"),
    ("tiny_d54_rgb", "mcd_train_b16_1024x512.json")])
def test_mcd_iterations_agree_float64(config, traffic):
    from mcseg_tpu_torch.train.mcd import make_mcd_step
    from mcseg_tpu_torch.train.state import create_train_state

    c, t = tiny_config(config, "float64"), tiny_traffic(traffic)
    cfg = _program_cfg(c, t)
    params = make_params(c["model"], generator(5, 1, device="cpu"))
    state = create_train_state(cfg.model, cfg.train, 5, "cpu", params=params)
    step = make_mcd_step(cfg.train, False, torch.float64)
    mcd = MCD(*_models(c["model"], params, torch.float64), t["train"])
    gen = torch.Generator().manual_seed(0)
    shape = (B, c["model"]["input_ch"], H, W)
    for it in range(3):
        xs = torch.randn(shape, generator=gen, dtype=torch.float64)
        xt = torch.randn(shape, generator=gen, dtype=torch.float64)
        ys = torch.randint(0, c["model"]["n_class"], (B, H, W), generator=gen)
        ys[:, :4] = 255
        got = step(state, xs.contiguous(memory_format=torch.channels_last), ys,
                   xt.contiguous(memory_format=torch.channels_last))
        want = mcd.iteration(xs, ys, xt)
        for k, v in want.items():
            tol = 1e-2 if (it, k) in ((1, "loss_dis"), (2, "loss_dis")) else 1e-8
            assert abs(float(got[k]) - float(v)) <= tol * abs(float(v)), (it, k)
        if it == 0:  # every leaf after one iteration
            for name, mod in state.modules().items():
                ref = mcd.mods[name].state_dict()
                for k, v in mod.state_dict().items():
                    if v.is_floating_point():
                        err = float((v - ref[k]).norm() / ref[k].norm().clamp_min(1e-12))
                        assert err < 1e-9, f"{name}.{k}: {err}"
                    else:
                        assert torch.equal(v, ref[k]), f"{name}.{k}"


def test_serve_logits_agree_float64():
    from mcseg_tpu_torch.eval.tester import InferenceCore

    from benchmark.drivers.serve import program_config

    c, t = tiny_config("tiny_d22", "float64"), tiny_traffic("serve_b8_closed.json")
    params = make_params(c["model"], generator(6, 1, device="cpu"))
    for sd in (params["G"],):  # trained-like running statistics
        for k in sd:
            if k.endswith("running_var"):
                sd[k] = torch.rand(sd[k].shape, generator=torch.Generator().manual_seed(1)) + 0.5
    core = InferenceCore(program_config(c, t), params, "cpu", (H, W))
    g, f1, f2 = (m.eval() for m in _models(c["model"], params, torch.float64))
    req = scenes(t["scene"], B, 1.0, generator(6, 4, device="cpu"), labels=False)
    img, _ = core.pp(req)
    x = img.permute(0, 3, 1, 2).to(torch.float64)
    with torch.no_grad():
        got = core.head(core.g(x))
        feat = g(x)
        want = 0.5 * (f1(feat) + f2(feat))
        assert torch.allclose(got, want, rtol=1e-9, atol=1e-9)
        xr = rp.serve_inputs(req, 6)
        assert float((xr - img.permute(0, 3, 1, 2).float()).abs().max()) < 5e-4


def test_control_does_not_agree():
    """The float8 control's first iteration sits far from float32, where
    float32 and float64 agree."""
    c, t = tiny_config("tiny_d22"), tiny_traffic("mcd_train_b24_640x480.json")
    params = make_params(c["model"], generator(7, 1, device="cpu"))
    gen = torch.Generator().manual_seed(1)
    shape = (B, 6, H, W)
    xs, xt = torch.randn(shape, generator=gen), torch.randn(shape, generator=gen)
    ys = torch.randint(0, 40, (B, H, W), generator=gen)
    losses = {}
    for name, dtype, precision in (("f64", torch.float64, None),
                                   ("f32", torch.float32, None), ("fp8", torch.float32, FP8)):
        mods = _models(c["model"], params, dtype)
        if precision is not None:
            set_precision(mods, **precision)
        losses[name] = MCD(*mods, t["train"]).iteration(xs.to(dtype), ys, xt.to(dtype))
    gap = {n: max(abs(float(losses[n][k]) / float(losses["f64"][k]) - 1)
                  for k in losses["f64"]) for n in ("f32", "fp8")}
    assert gap["f32"] < 1e-4
    assert gap["fp8"] > 10 * gap["f32"] and gap["fp8"] > 1e-4
