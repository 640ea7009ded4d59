"""The port's serving artifact (``mcseg_tpu_torch/eval/serving.py``
``export_serving`` / ``load_serving``, ``tools/export_serving.py``) against
the JAX package's (``mcseg_tpu/eval/serving.py``), and what makes it
exportable: the normalize kernel as the custom op ``mcseg::normalize_stack``
and an HHA encoder that reads no tensor data on the host.

drn_d_14, 8 classes, 32x32, float32 on both sides; the JAX state's weights
carried by ``params_from_jax``; inputs from numpy seeds. Bounds: the port's
artifact, loaded back, gives JAX's artifact's class map exactly and its
probabilities within 1e-5 (float32 softmax of logits that agree to ~1e-6),
its depth head within 1e-4 m; the artifact equals the port's in-process
serving exactly (the same CPU kernels in the same order). The manifest has
JAX's keys and values, apart from ``format``'s value and the two keys
renamed for PyTorch (``platforms`` -> ``device``,
``calling_convention_version`` -> ``torch_version``) and ``bytes``.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import mcseg_tpu_torch.eval.serving as serving
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.eval.serving import export_serving as jax_export_serving
from mcseg_tpu.eval.serving import load_serving as jax_load_serving
from mcseg_tpu.train.multitask import init_multitask_state as jax_init_multitask_state
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.data.transforms import save_png
from mcseg_tpu_torch.eval.serving import export_serving, load_serving, make_serve_fn
from mcseg_tpu_torch.ops.hha import depth_to_hha_batch
from mcseg_tpu_torch.ops.normalize import fused_normalize_stack, normalize_stack_reference
from mcseg_tpu_torch.tools import export_serving as export_tool
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import save_checkpoint
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBS_ATOL = 1e-5
DEPTH_ATOL = 1e-4
RENAMED = ({"platforms", "calling_convention_version"}, {"device", "torch_version"})


@functools.lru_cache(maxsize=None)
def _setup(input_ch=3, fusion="single", multitask=False):
    """(JAX config, JAX params, JAX batch_stats, port config, port params)."""
    model = JaxModelConfig(net="drn_d_14", input_ch=input_ch, n_class=8, dtype="float32",
                           fusion=fusion)
    cfg = JaxExperimentConfig(
        model=model,
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic", batch_size=2,
                           train_img_shape=(32, 32), test_img_shape=(32, 32),
                           input_ch=input_ch),
        train=JaxTrainConfig())
    if multitask:
        state, *_ = jax_init_multitask_state(model, cfg.train, jax.random.key(0),
                                             img_shape=(32, 32))
    else:
        state, _, _ = jax_create_train_state(model, cfg.train, jax.random.key(0),
                                             img_shape=(32, 32))
    to_np = jax.tree.map(np.asarray, (state.params, state.batch_stats))
    return (cfg, state.params, state.batch_stats, ExperimentConfig.from_dict(cfg.to_dict()),
            params_from_jax(*to_np))


def _with_data(cfg, pcfg, **kw):
    return (dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **kw)),
            dataclasses.replace(pcfg, data=dataclasses.replace(pcfg.data, **kw)))


def _planes(spec, seed):
    """Random raw planes for an input spec {name: (shape, dtype)}."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, (shape, dt) in spec.items():
        if k == "depth":
            out[k] = (rng.rand(*shape) * 4 + 0.5).astype(np.float32)
        elif k == "boundary":
            out[k] = (rng.rand(*shape) < 0.1).astype(np.uint8) * 255
        else:
            out[k] = rng.randint(0, 256, shape).astype(np.uint8)
    return out


def _spec(manifest):
    return {k: (tuple(v["shape"]), v["dtype"]) for k, v in manifest["input_spec"].items()}


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _check_manifests(ours, theirs):
    assert set(ours) - RENAMED[1] == set(theirs) - RENAMED[0]
    assert ours["format"] == "torch.export" and ours["torch_version"] == torch.__version__
    for k in set(theirs) - RENAMED[0] - {"format", "bytes"}:
        assert ours[k] == theirs[k], k


def _against_jax(tmp_path, setup, batch=1, seed=0, **kw):
    """Export both packages' artifacts of ``setup`` with the same options,
    feed both one request, hold outputs and manifests; returns (port
    outputs, port manifest, request)."""
    cfg, jparams, jstats, pcfg, pparams = setup
    want_m = jax_export_serving(cfg, jparams, jstats, str(tmp_path / "jax.shlo"), batch=batch,
                                platforms=("cpu",), **kw)
    got_m = export_serving(pcfg, pparams, str(tmp_path / "port.pt2"), batch=batch,
                           device="cpu", **kw)
    _check_manifests(got_m, want_m)
    request = _planes(_spec(got_m), seed)
    want = _as_tuple(jax_load_serving(str(tmp_path / "jax.shlo"))(request))
    got = _as_tuple(load_serving(str(tmp_path / "port.pt2"))(request))
    assert len(got) == len(want) == len(got_m["outputs"])
    for name, g, w in zip(got_m["outputs"], got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "pred":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=PROBS_ATOL if name == "probs" else DEPTH_ATOL)
    return got, got_m, request


def test_normalize_stack_is_a_registered_custom_op():
    op = torch.ops.mcseg.normalize_stack.default
    assert "mcseg::normalize_stack" in str(op._schema)
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.randint(0, 256, (2, 4, 5, 3)).astype(np.uint8))
    extra = torch.from_numpy(rng.rand(2, 4, 5, 3).astype(np.float32))
    flip = torch.tensor([0, 1], dtype=torch.int32)
    before = fused_normalize_stack.launches
    for out_dtype in (torch.float32, torch.bfloat16):
        got = op(rgb, extra, flip, 6, out_dtype)
        assert torch.equal(got, normalize_stack_reference(rgb, extra, flip, 6, out_dtype))
        with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
            fake = op(mode.from_tensor(rgb), mode.from_tensor(extra),
                      mode.from_tensor(flip), 6, out_dtype)
        assert tuple(fake.shape) == (2, 4, 5, 6) and fake.dtype == out_dtype
    assert fused_normalize_stack.launches == before  # the CPU never launches


def test_exported_graph_holds_the_op_as_one_node():
    class Stack(torch.nn.Module):
        def forward(self, rgb, extra, flip):
            return fused_normalize_stack(rgb, extra, flip, 6, torch.bfloat16)

    rng = np.random.RandomState(1)
    args = (torch.from_numpy(rng.randint(0, 256, (2, 6, 7, 3)).astype(np.uint8)),
            torch.from_numpy(rng.rand(2, 6, 7, 3).astype(np.float32)),
            torch.tensor([1, 0], dtype=torch.int32))
    program = torch.export.export(Stack(), args)
    targets = [n.target for n in program.graph.nodes if n.op == "call_function"]
    assert targets == [torch.ops.mcseg.normalize_stack.default]
    assert torch.equal(program.module()(*args), Stack()(*args))


def test_hha_encoder_exports_and_equals_eager():
    rng = np.random.RandomState(2)
    depth = (rng.rand(2, 48, 64) * 4 + 0.5).astype(np.float32)
    depth[0, :5] = 0.0  # missing depth
    depth[1, 10:12, 3:9] = np.nan

    class HHA(torch.nn.Module):
        def forward(self, d):
            return depth_to_hha_batch(d)

    program = torch.export.export(HHA(), (torch.zeros(2, 48, 64),))
    d = torch.from_numpy(depth)
    assert torch.equal(program.module()(d), depth_to_hha_batch(d))


def test_depth_input_with_probs_matches_jax_and_loads_in_a_fresh_process(tmp_path):
    """input_ch 6 fed raw depth (HHA inside the artifact), batch 2, probs."""
    setup = _setup(6)
    got, manifest, request = _against_jax(tmp_path, setup, batch=2, seed=1, with_probs=True)
    assert manifest["outputs"] == ["pred", "probs"] and manifest["extra_plane"] == "depth"
    assert set(manifest["input_spec"]) == {"image", "depth"}
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, rtol=1e-5)
    # the artifact runs the in-process serving path exactly
    _, _, _, pcfg, pparams = setup
    live = make_serve_fn(pcfg, pparams, device="cpu", with_probs=True)(request)
    assert torch.equal(live[0], got[0]) and torch.equal(live[1], got[1])

    np.savez(tmp_path / "request.npz", **request)
    script = (  # the test process's CPU threads, so that both reduce alike
        f"import sys, numpy as np, torch; torch.set_num_threads({torch.get_num_threads()})\n"
        "from mcseg_tpu_torch.eval.serving import load_serving\n"
        f"call = load_serving({str(tmp_path / 'port.pt2')!r})\n"
        f"pred, probs = call(dict(np.load({str(tmp_path / 'request.npz')!r})))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, pred=pred.numpy(), probs=probs.numpy())\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] in ('jax', 'mcseg_tpu')]\n"
        "assert not leaked, leaked\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    fresh = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(fresh["pred"], got[0].numpy())
    np.testing.assert_array_equal(fresh["probs"], got[1].numpy())


def test_precomputed_hha_plane_matches_jax(tmp_path):
    cfg, *rest = _setup(6)
    pcfg = rest[2]
    cfg, pcfg = _with_data(cfg, pcfg, hha_on_device=False)
    _, m, _ = _against_jax(tmp_path, (cfg, rest[0], rest[1], pcfg, rest[3]), seed=2)
    assert m["extra_plane"] == "hha" and set(m["input_spec"]) == {"image", "hha"}


def test_depth_only_needs_no_image_and_matches_jax(tmp_path):
    _, m, _ = _against_jax(tmp_path, _setup(1), seed=3)
    assert list(m["input_spec"]) == ["depth"] and "per-batch depth max" in m["note"]


def test_missing_data_root_falls_back_to_test_img_shape(tmp_path):
    cfg, jp, js, pcfg, pp = _setup(3)
    cfg, pcfg = _with_data(cfg, pcfg, tgt_dataset="nyu", data_root="/nonexistent/host")
    _, m, _ = _against_jax(tmp_path, (cfg, jp, js, pcfg, pp), seed=4)
    assert m["input_spec"]["image"]["shape"] == [1, 32, 32, 3]


@pytest.mark.parametrize("input_ch,tgt,extra_plane", [
    (3, "synthetic", "depth"), (3, "synthetic", "edges"), (3, "synthetic", "boundary"),
    (6, "synthetic", "boundary"), (6, "synthetic", "ir"), (7, "synthetic", "ir"),
    (7, "synthetic", "boundary"), (1, "synthetic", "boundary"), (4, "ir", "edges"),
])
def test_extra_plane_validation_raises_the_jax_message(input_ch, tgt, extra_plane):
    cfg, jp, js, pcfg, pp = _setup(input_ch)
    cfg, pcfg = _with_data(cfg, pcfg, tgt_dataset=tgt)
    with pytest.raises(ValueError) as theirs:
        jax_export_serving(cfg, jp, js, "/nonexistent/x.shlo", platforms=("cpu",),
                           extra_plane=extra_plane)
    with pytest.raises(ValueError) as ours:
        export_serving(pcfg, pp, "/nonexistent/x.pt2", device="cpu",
                       extra_plane=extra_plane)
    assert str(ours.value) == str(theirs.value)


def _write_ir_corpus(root, with_depth):
    rng = np.random.RandomState(0)
    for sub in ("val_rgb", "val_label", "val_ir") + (("val_depth",) if with_depth else ()):
        os.makedirs(root / sub, exist_ok=True)
    for i in range(2):
        name = f"{i:04d}.png"
        save_png(rng.randint(0, 256, (32, 32, 3)).astype(np.uint8), root / "val_rgb" / name)
        save_png(rng.randint(0, 19, (32, 32)).astype(np.uint8), root / "val_label" / name)
        save_png(rng.randint(0, 256, (32, 32)).astype(np.uint8), root / "val_ir" / name)
        if with_depth:
            save_png(rng.randint(500, 4000, (32, 32)).astype(np.uint16), root / "val_depth" / name)


@pytest.mark.parametrize("corpus", ["unreachable", "ir_only", "ir_and_depth"])
def test_ir_corpus_plane_resolves_as_jax(tmp_path, corpus):
    """input_ch 4 on the IR corpus (and 6 where it is unreachable): the
    manifests (plane, plane_note, the corpus's decode geometry) equal
    JAX's."""
    root = "/nonexistent"
    if corpus != "unreachable":
        _write_ir_corpus(tmp_path / "ir", with_depth=corpus == "ir_and_depth")
        root = str(tmp_path)
    for input_ch in (4, 6) if corpus == "unreachable" else (4,):
        cfg, jp, js, pcfg, pp = _setup(input_ch)
        cfg, pcfg = _with_data(cfg, pcfg, tgt_dataset="ir", data_root=root)
        want = jax_export_serving(cfg, jp, js, str(tmp_path / "j.shlo"), platforms=("cpu",))
        got = export_serving(pcfg, pp, str(tmp_path / "p.pt2"), device="cpu")
        _check_manifests(got, want)
        if input_ch == 4:
            assert got["extra_plane"] == {"unreachable": "depth", "ir_only": "ir",
                                          "ir_and_depth": "depth"}[corpus]
            assert ("plane_note" in got) == (corpus == "unreachable")
        else:
            assert got["extra_plane"] == "depth" and "plane_note" not in got


def test_multitask_depth_head_matches_jax(tmp_path):
    setup = _setup(3, multitask=True)
    got, m, _ = _against_jax(tmp_path, setup, seed=5)
    assert m["outputs"] == ["pred", "depth"] and got[1].dtype == torch.float32
    cfg, jp, js, pcfg, pp = setup
    opt_out = export_serving(pcfg, pp, str(tmp_path / "p2.pt2"), device="cpu",
                             with_depth=False)
    assert opt_out["outputs"] == ["pred"]


def test_late_fusion_matches_jax(tmp_path):
    _, m, _ = _against_jax(tmp_path, _setup(6, fusion="late"), seed=6)
    assert m["extra_plane"] == "depth"


def test_input_ch4_boundary_plane_matches_jax(tmp_path):
    _, m, _ = _against_jax(tmp_path, _setup(4), seed=7, extra_plane="boundary")
    assert m["extra_plane"] == "boundary" and set(m["input_spec"]) == {"image", "boundary"}


def test_input_ch7_matches_jax(tmp_path):
    _, m, _ = _against_jax(tmp_path, _setup(7), seed=8)
    assert set(m["input_spec"]) == {"image", "depth", "boundary"}


def test_export_tool_writes_bucketed_artifacts(tmp_path, capsys):
    """``--batch 1,2`` writes <out>.b1 and <out>.b2 from a port checkpoint,
    each loadable at its own batch and equal to in-process serving."""
    _, _, _, pcfg, pparams = _setup(3)
    state = create_train_state(pcfg.model, pcfg.train, 0, "cpu", params=pparams)
    save_checkpoint(str(tmp_path / "ck"), state, pcfg)
    out = str(tmp_path / "m.pt2")
    manifests = export_tool.main([str(tmp_path / "ck"), "--out", out, "--batch", "1,2",
                                  "--f1_only"], device="cpu")
    assert [m["input_spec"]["image"]["shape"][0] for m in manifests] == [1, 2]
    assert all(m["device"] == "cpu" and not m["average_classifiers"] for m in manifests)
    assert capsys.readouterr().out.count("wrote ") == 2
    live = make_serve_fn(pcfg, pparams, device="cpu", average_classifiers=False)
    for b in (1, 2):
        request = _planes({"image": ((b, 32, 32, 3), "uint8")}, seed=b)
        pred = load_serving(f"{out}.b{b}")(request)
        assert tuple(pred.shape) == (b, 32, 32)
        assert torch.equal(pred, live(request))


def test_export_is_atomic(tmp_path, monkeypatch):
    """A crash while publishing leaves neither artifact nor manifest at the
    final paths (tmp + os.replace)."""
    _, _, _, pcfg, pparams = _setup(3)
    path = str(tmp_path / "m.pt2")

    def boom(src, dst):
        raise RuntimeError("simulated crash during finalize")

    monkeypatch.setattr(serving.os, "replace", boom)
    with pytest.raises(RuntimeError, match="simulated crash"):
        export_serving(pcfg, pparams, path, device="cpu")
    assert not os.path.exists(path) and not os.path.exists(path + ".json")
    monkeypatch.undo()
    export_serving(pcfg, pparams, path, device="cpu")
    assert os.path.exists(path) and os.path.exists(path + ".json")
    with open(path + ".json") as f:
        assert json.load(f)["bytes"] == os.path.getsize(path)


def test_load_serving_refuses_another_device(tmp_path):
    _, _, _, pcfg, pparams = _setup(3)
    path = str(tmp_path / "m.pt2")
    export_serving(pcfg, pparams, path, device="cpu")
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        load_serving(path, device="cuda")
    with open(path + ".json") as f:
        manifest = json.load(f)
    manifest["device"] = "cuda"
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_serving(path)
