"""The port's reference command lines (``mcseg_tpu_torch/cli``) against the
JAX package's, and end to end on the CPU.

Parsing: the same reference command line gives the same ExperimentConfig
dict in both packages, the testing parser the same namespace, and a bad
choice is refused by both. A ``--spatial_devices`` layout whose row
blocks FCN8s's pools cannot split raises ``ValueError``; the parallelism
flags run a gloo group of one. ``--resume`` checks
the checkpoint's structure first, with JAX's message.

End to end: drn_d_14, 40 classes, float32, batch 2 of ``synthetic`` ->
``synthetic_shifted`` decoded at 32x24, 2 samples per corpus (one
iteration per epoch). ``main(argv, device="cpu")`` of each command; the
run directory's files, ``--keep_checkpoints`` pruning, the epoch-eval
hook, the tester's F1/F2 choice, and a resumed run landing bit-equal on an
uninterrupted one.

The multitask command (``cli/multitask_train.py``): its flags give the
JAX command's config and weights; MCD with a boundary head and
``--source_only`` end to end, the checkpoint round trip with the "D" and
"B" heads, the test command's depth and boundary lines, a resumed run, the
two resume refusals with the JAX trainer's messages, and the refusal of
late fusion before any state is built.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

import mcseg_tpu.cli.multitask_train as jax_multitask_train
import mcseg_tpu.train.loops as jax_loops
import mcseg_tpu.train.multitask as jax_multitask
from mcseg_tpu.cli import argparse_compat as jax_cli
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.train.loops import _check_resume_config as jax_check_resume_config
from mcseg_tpu_torch.cli import (
    _epoch_eval, adapt_test, adapt_train, multitask_train, source_test, source_train)
from mcseg_tpu_torch.cli import argparse_compat as cli
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.train import loops
from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, load_params
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

COMMAND_LINES = {
    "adapt_suncg_nyu_rgbhha": (True, "suncg nyu --input_ch 6 --num_k 4"),
    "adapt_gta5_city": (True, "gta5 city"),
    "source_nyu_drn_c_42": (False, "nyu --net drn_c_42"),
    "adapt_late_fusion": (True, "suncg nyu --fusion late --input_ch 6 --net drn_d_54 "
                                "--d_loss symkl --opt adam --lr 2e-4"),
    "source_rgbd_resize": (False, "nyu --input_ch 4 --upsample resize --train_img_shape 321 241 "
                                  "--no_random_crop --keep_checkpoints 3 --max_hours 1.5"),
    "adapt_s2d_on_inert_flags": (True, "synthetic synthetic_shifted --s2d on --num_workers 2 "
                                       "--device_corpus off --decode_cache_gb 0 "
                                       "--decode_disk_cache_gb 2 --sync_checkpoint "
                                       "--uses_one_classifier --test_img_shape 64 48"),
}


@pytest.mark.parametrize("name", sorted(COMMAND_LINES))
def test_reference_command_line_gives_the_jax_config(name):
    adapt, line = COMMAND_LINES[name]
    argv = line.split()
    ours = cli.get_da_mcd_training_parser() if adapt else cli.get_src_only_training_parser()
    theirs = (jax_cli.get_da_mcd_training_parser() if adapt
              else jax_cli.get_src_only_training_parser())
    a, b = ours.parse_args(argv), theirs.parse_args(argv)
    assert vars(a) == vars(b)
    cfg = cli.args_to_config(a, adapt)
    assert cfg.to_dict() == jax_cli.args_to_config(b, adapt).to_dict()
    assert ExperimentConfig.from_dict(cfg.to_dict()) == cfg
    cli.reject_unported(a)  # every flag of these lines is ported or inert


def test_testing_parser_and_bad_choices_match_jax():
    argv = "ckpt/last nyu --split val --batch_size 4 --test_img_shape 64 48 " \
           "--f1_only --use_f2 --max_samples 3 --data_root /d".split()
    assert vars(cli.get_testing_parser().parse_args(argv)) == \
        vars(jax_cli.get_testing_parser().parse_args(argv))
    assert cli.fix_img_shape_args((321, 241)) == jax_cli.fix_img_shape_args((321, 241))
    for bad in ("nyu --input_ch 5", "nyu --fusion middle", "nyu --upsample nearest",
                "nyu --dtype float16"):
        for parser in (cli.get_src_only_training_parser(),
                       jax_cli.get_src_only_training_parser()):
            with pytest.raises(SystemExit):
                parser.parse_args(bad.split())


@pytest.mark.parametrize("main,argv", [
    (source_train.main, "synthetic --net fcn8s_vgg16 --train_img_shape 640 480 "
                        "--spatial_devices 2"),
], ids=lambda v: v.split()[-1] if isinstance(v, str) else None)
def test_unported_output_flags_raise(main, argv, tmp_path):
    """Every trunk partitions its rows; FCN8s's five pools need the train
    height a multiple of 32 x the row blocks, which 480 rows in 2 are not."""
    with pytest.raises(ValueError, match=r"train height 480 .* --net fcn8s_vgg16 .* "
                                         r"multiple of 64 \(32x2\)"):
        main(argv.split() + ["--out_dir", str(tmp_path / "run")], device="cpu")
    assert not os.path.exists(tmp_path / "run")  # refused before anything was written


def _group_flags(port):
    return ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "1", "--process_id", "0"]


@pytest.mark.parametrize("flag", ["multihost", "coordinator", "num_processes", "process_id",
                                  "all_devices"])
def test_group_flags_work_on_the_cpu(flag, tmp_path, monkeypatch):
    """The parallelism flags through their command's ``main(..., device="cpu")``,
    each run a gloo group of one rank that the command joins and leaves:
    ``--multihost`` from torchrun's variables; ``--coordinator`` with
    ``--num_processes`` and ``--process_id`` (the loss of the group's
    global batch, here the one rank's, matches the same command without a
    group within float32 rounding); ``--num_processes`` without
    ``--coordinator`` refused before anything is written; ``--process_id``
    with the epoch-eval hook scoring under the group; ``--all_devices``
    scoring on every device of the process (here the one CPU) as plain
    scoring does."""
    import torch.distributed as dist

    from _torch_parallel_worker import free_port

    run = tmp_path / "run"
    if flag == "multihost":
        for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0",
                         WORLD_SIZE="1", LOCAL_RANK="0").items():
            monkeypatch.setenv(k, v)
        state = _adapt(run, 1, "--multihost")
        assert state.step == 1
    elif flag == "coordinator":
        state = source_train.main(["synthetic", *_argv(run, 1), *_group_flags(free_port())],
                                  device="cpu")
        plain = source_train.main(["synthetic", *_argv(tmp_path / "plain", 1)], device="cpu")
        got, want = (_logged_losses(d, ("loss",)) for d in (run, tmp_path / "plain"))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert state.step == plain.step == 1
    elif flag == "num_processes":
        with pytest.raises(ValueError, match="need --coordinator"):
            source_train.main(["synthetic", *_argv(run, 1), "--num_processes", "1"],
                              device="cpu")
        assert not os.path.exists(run)
    elif flag == "process_id":
        state = _adapt(run, 1, "--eval_every_epochs", "1", *_group_flags(free_port()))
        with open(run / "train_log.jsonl") as f:
            evals = [r for r in map(json.loads, f) if "val_miou" in r]
        assert state.step == 1 and len(evals) == 1 and np.isfinite(evals[0]["val_miou"])
    else:
        _adapt(run, 1)
        plain = source_test.main([str(run / "last")], device="cpu")
        assert source_test.main([str(run / "last"), "--all_devices"], device="cpu") == plain
    assert not dist.is_initialized()  # the command left its group
    if flag in ("multihost", "coordinator", "process_id"):
        assert {"args.json", "last.pt", "train_log.jsonl"} <= set(os.listdir(run))


def _logged_losses(run, keys):
    with open(os.path.join(run, "train_log.jsonl")) as f:
        return np.array([[r[k] for k in keys] for r in map(json.loads, f) if "step" in r])


@pytest.fixture(scope="module")
def small_checkpoint(tmp_path_factory):
    """An input_ch 4 MCD checkpoint of one iteration (2 val samples)."""
    run = tmp_path_factory.mktemp("ckpt") / "adapt"
    _adapt(run, 1)
    return str(run / "last")


def _tb_scalars(tb_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (path,) = [os.path.join(tb_dir, f) for f in os.listdir(tb_dir)]
    acc = EventAccumulator(path)
    acc.Reload()
    return {t: [e.step for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


@pytest.mark.parametrize("case", ["adapt_train --tb_dir", "source_train --tb_dir",
                                  "adapt_test --outdir", "source_test --outdir --saves_prob"])
def test_output_flags_write_their_outputs(case, small_checkpoint, tmp_path):
    """The run-output flags through their command's ``main(..., device="cpu")``:
    TensorBoard scalars of every logged step, and the tester's dumps of
    every val sample (2 here), with float16 [H,W,n_class] probabilities
    only under --saves_prob."""
    out = str(tmp_path / "out")
    if case == "adapt_train --tb_dir":
        _adapt(tmp_path / "run", 1, "--tb_dir", out)
        assert _tb_scalars(out) == {k: [0] for k in ("loss_source", "loss_b", "loss_dis",
                                                     "lr", "img_per_sec")}
    elif case == "source_train --tb_dir":
        source_train.main(["synthetic", "--input_ch", "1", *_argv(tmp_path / "run", 1),
                           "--tb_dir", out], device="cpu")
        assert _tb_scalars(out) == {"loss": [0], "lr": [0], "img_per_sec": [0]}
    else:
        main = adapt_test.main if case.startswith("adapt") else source_test.main
        miou = main([small_checkpoint, *case.split()[1:2], out, *case.split()[2:]],
                    device="cpu")
        assert np.isfinite(miou)
        kinds = ["color.png", "label.png"] + (["prob.npy"] if "--saves_prob" in case else [])
        assert sorted(os.listdir(out)) == [f"{i:06d}_{k}" for i in range(2) for k in kinds]
        if "--saves_prob" in case:
            probs = np.load(os.path.join(out, "000000_prob.npy"))
            assert probs.dtype == np.float16 and probs.shape == (24, 32, 40)
            np.testing.assert_allclose(probs.astype(np.float32).sum(-1), 1.0, atol=2e-2)


@pytest.mark.parametrize("section,name,value", [
    ("model", "net", "drn_d_22"), ("model", "input_ch", 4), ("model", "n_class", 19),
    ("model", "method", "source"), ("model", "fusion", "late"),
    ("model", "upsample", "resize"), ("train", "opt", "adam"),
])
def test_resume_check_names_each_structural_field_as_jax(section, name, value):
    base = ExperimentConfig()
    drifted = dataclasses.replace(
        base, **{section: dataclasses.replace(getattr(base, section), **{name: value})})
    with pytest.raises(ValueError) as ours:
        loops._check_resume_config(drifted, base, "runs/x/last")
    with pytest.raises(ValueError) as theirs:
        jax_check_resume_config(JaxExperimentConfig.from_dict(drifted.to_dict()),
                                JaxExperimentConfig.from_dict(base.to_dict()), "runs/x/last")
    assert str(ours.value) == str(theirs.value)
    assert f"--{name}: checkpoint has" in str(ours.value)
    loops._check_resume_config(base, base, "runs/x/last")  # no drift, no error


def _argv(out_dir, epochs=2, *extra):
    return ["--net", "drn_d_14", "--n_class", "40", "--dtype", "float32", "--batch_size", "2",
            "--train_img_shape", "32", "24", "--max_samples", "2", "--epochs", str(epochs),
            "--lr", "0.01", "--max_steps", "10", "--log_every", "1",
            "--out_dir", str(out_dir), *extra]


def _adapt(out_dir, epochs=2, *extra):
    return adapt_train.main(["synthetic", "synthetic_shifted", "--num_k", "2", "--input_ch", "4",
                             *_argv(out_dir, epochs, *extra)], device="cpu")


def test_adapt_train_and_test_end_to_end(tmp_path):
    run = tmp_path / "adapt"
    state = _adapt(run, 2, "--keep_checkpoints", "1", "--eval_every_epochs", "1")
    assert state.step == 2
    assert sorted(os.listdir(run)) == ["args.json", "ep2.config.json", "ep2.pt",
                                       "last.config.json", "last.pt", "train_log.jsonl"]
    with open(run / "args.json") as f:
        args_cfg = ExperimentConfig.from_dict(json.load(f))
    params, cfg = load_params(str(run / "last"))
    assert cfg == args_cfg and cfg.model.input_ch == 4 and cfg.model.method == "MCD"
    with open(run / "train_log.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    steps = [r for r in lines if "loss_source" in r]
    evals = [r for r in lines if "val_miou" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(r[k]) for r in steps for k in ("loss_source", "loss_b", "loss_dis"))
    assert [(r["step"], r["epoch"]) for r in evals] == [(1, 1), (2, 2)]
    miou = adapt_test.main([str(run / "last")], device="cpu")
    want, _, _ = evaluate(params, cfg, print_table=False, device="cpu")
    assert miou == want and np.isfinite(miou)
    f1_only = adapt_test.main([str(run / "last"), "--f1_only"], device="cpu")
    assert f1_only == evaluate(params, cfg, print_table=False, device="cpu",
                               average_classifiers=False)[0]


def test_source_train_and_test_end_to_end(tmp_path):
    run = tmp_path / "source"
    state = source_train.main(["synthetic", "--input_ch", "1", *_argv(run, 2)], device="cpu")
    assert state.step == 2
    for name in ("args.json", "ep1.pt", "ep2.pt", "last.pt", "last.config.json"):
        assert os.path.exists(run / name), name  # keep_checkpoints 0 keeps every epoch
    with open(run / "train_log.jsonl") as f:
        lines = [json.loads(ln) for ln in f]
    assert [r["step"] for r in lines] == [0, 1] and all(np.isfinite(r["loss"]) for r in lines)
    params, cfg = load_params(str(run / "last"))
    assert cfg.model.method == "source" and cfg.model.input_ch == 1
    f1 = evaluate(params, cfg, print_table=False, device="cpu", average_classifiers=False)[0]
    both = evaluate(params, cfg, print_table=False, device="cpu")[0]
    assert source_test.main([str(run / "last")], device="cpu") == f1
    assert source_test.main([str(run / "last"), "--use_f2"], device="cpu") == both


def test_adapt_train_and_test_psp_end_to_end(tmp_path, monkeypatch):
    """``--net psp`` through both commands, then a ``--resume`` of its
    checkpoint into another trunk, refused with JAX's structure message
    before any state is built."""
    run = tmp_path / "psp"
    argv = ["synthetic", "synthetic_shifted", "--num_k", "2", "--input_ch", "6",
            *_argv(run, 1)]
    argv[argv.index("drn_d_14")] = "psp"
    state = adapt_train.main(argv, device="cpu")
    assert state.step == 1 and state.masks is None  # no dropout in this trunk
    params, cfg = load_params(str(run / "last"))
    assert cfg.model.net == "psp" and "ppm.fuse.weight" in params["G"]
    (r,) = [r for r in _train_log(run) if "loss_source" in r]
    assert all(np.isfinite(r[k]) for k in ("loss_source", "loss_b", "loss_dis"))
    miou = adapt_test.main([str(run / "last")], device="cpu")
    assert np.isfinite(miou) and miou == evaluate(params, cfg, print_table=False, device="cpu")[0]
    built = []
    monkeypatch.setattr(loops, "create_train_state", lambda *a, **k: built.append(a))
    with pytest.raises(ValueError, match="--net: checkpoint has 'psp', CLI has 'drn_d_14'"):
        _adapt(tmp_path / "drift", 2, "--input_ch", "6", "--resume", str(run / "last"))
    assert not built


def test_cli_resume_repeats_the_uninterrupted_run(tmp_path, monkeypatch):
    full = _adapt(tmp_path / "full", 2)
    _adapt(tmp_path / "cut", 1)
    last = str(tmp_path / "cut" / "last")
    # a structural drift is refused before any state is built
    calls = []
    monkeypatch.setattr(loops, "load_checkpoint", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="--upsample: checkpoint has 'convt', CLI has 'resize'"):
        _adapt(tmp_path / "cut", 2, "--resume", last, "--upsample", "resize")
    assert not calls
    monkeypatch.undo()
    resumed = _adapt(tmp_path / "cut", 2, "--resume", last)
    assert resumed.step == full.step == 2
    for a, b in ((full.g, resumed.g), (full.f1, resumed.f1), (full.f2, resumed.f2)):
        for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(x, y), k


def test_epoch_eval_hook_without_val_split(capsys, monkeypatch):
    def no_split(*a, **k):
        raise FileNotFoundError("no val split")

    monkeypatch.setattr(_epoch_eval, "get_dataset", no_split)
    assert _epoch_eval.make_epoch_eval_hook(ExperimentConfig(), 1, device="cpu") is None
    assert "epoch-end eval disabled" in capsys.readouterr().out
    assert _epoch_eval.make_epoch_eval_hook(ExperimentConfig(), 0, device="cpu") is None


MULTITASK_LINES = {
    # the JAX package's documented multitask command (docs/BASELINE_RUNS.md)
    "rgb_depth_mcd": "suncg nyu --input_ch 3 --data_root /data --depth_weight 0.5",
    "boundary_source_only": "synthetic synthetic_shifted --boundary_weight 1.0 --source_only "
                            "--net drn_d_22 --depth_weight 0.25",
}


@pytest.mark.parametrize("name", sorted(MULTITASK_LINES))
def test_multitask_command_line_gives_the_jax_run(name, tmp_path, monkeypatch):
    """Both ``main``s on one command line, each trainer replaced by a
    recorder: the same config dict and the same multitask arguments."""
    argv = MULTITASK_LINES[name].split() + ["--out_dir", str(tmp_path / "run")]
    seen = {}

    def recorder(side):
        def train(cfg, **kw):
            seen[side] = (cfg.to_dict(), {k: kw[k] for k in
                                          ("depth_weight", "boundary_weight", "adapt")})
        return train

    monkeypatch.setattr(jax_multitask_train, "train_multitask", recorder("jax"))
    jax_multitask_train.main(argv)
    monkeypatch.setattr(multitask_train, "train_multitask", recorder("port"))
    multitask_train.main(argv, device="cpu")
    assert seen["port"] == seen["jax"]
    assert seen["port"][1]["adapt"] == ("--source_only" not in argv)


def _multitask(out_dir, epochs=2, *extra):
    return multitask_train.main(["synthetic", "synthetic_shifted", "--num_k", "2",
                                 *_argv(out_dir, epochs, *extra)], device="cpu")


def _train_log(run):
    with open(run / "train_log.jsonl") as f:
        return [json.loads(ln) for ln in f]


def test_multitask_mcd_with_boundary_end_to_end(tmp_path, capsys):
    run = tmp_path / "mt"
    state = _multitask(run, 2, "--boundary_weight", "1.0", "--eval_every_epochs", "2")
    assert state.step == 2 and state.d is not None and state.b is not None
    lines = _train_log(run)
    steps = [r for r in lines if "loss_source" in r]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        assert {"loss_seg", "loss_depth", "loss_b", "loss_dis", "lr", "loss_boundary"} <= set(r)
        assert all(np.isfinite(r[k]) for k in ("loss_source", "loss_depth", "loss_boundary"))
    assert [r["epoch"] for r in lines if "val_miou" in r] == [2]
    # the checkpoint round trip keeps both heads and their optimizer state
    restored, cfg = load_checkpoint(str(run / "last"), "cpu")
    assert restored.step == 2 and cfg.model.method == "MCD"
    saved, back = state.params(), restored.params()
    assert sorted(back) == ["B", "D", "F1", "F2", "G"]
    for name in saved:
        for k in saved[name]:
            assert torch.equal(saved[name][k], back[name][k]), (name, k)
    opt, opt_back = state.opt_f.state_dict(), restored.opt_f.state_dict()
    assert len(opt_back["state"]) == len(opt["state"]) == 8  # F1, F2, D, B: weight + bias
    for i, st in opt["state"].items():
        assert torch.equal(st["momentum_buffer"], opt_back["state"][i]["momentum_buffer"])
    params, _ = load_params(str(run / "last"))
    assert sorted(params) == ["B", "D", "F1", "F2", "G"]
    capsys.readouterr()
    miou = adapt_test.main([str(run / "last")], device="cpu")
    out = capsys.readouterr().out
    assert np.isfinite(miou)
    for line in ("depth: rmse=", "boundary (tol=2px): precision=", "boundary (strict):  precision="):
        assert line in out, out[-500:]


def test_multitask_source_only_end_to_end(tmp_path, capsys):
    run = tmp_path / "mt_src"
    state = _multitask(run, 1, "--source_only", "--input_ch", "3")
    assert state.step == 1 and state.b is None
    (r,) = _train_log(run)
    assert set(r) == {"step", "loss", "loss_seg", "loss_depth", "lr", "img_per_sec"}
    params, cfg = load_params(str(run / "last"))
    assert sorted(params) == ["D", "F1", "F2", "G"] and cfg.model.method == "source"
    capsys.readouterr()
    source_test.main([str(run / "last")], device="cpu")
    out = capsys.readouterr().out
    assert "depth: rmse=" in out and "boundary" not in out


def test_multitask_resume_repeats_the_uninterrupted_run(tmp_path):
    full = _multitask(tmp_path / "full", 2, "--boundary_weight", "1.0")
    _multitask(tmp_path / "cut", 1, "--boundary_weight", "1.0")
    resumed = _multitask(tmp_path / "cut", 2, "--boundary_weight", "1.0",
                         "--resume", str(tmp_path / "cut" / "last"))
    assert resumed.step == full.step == 2
    for name, sd in full.params().items():
        for k, v in sd.items():
            assert torch.equal(v, resumed.params()[name][k]), (name, k)


def _jax_resume_refusal(monkeypatch, tmp_path, resume, ckpt_heads, boundary_weight):
    """The JAX trainer's refusal of resuming ``resume``, whose checkpoint
    holds the subtrees ``ckpt_heads``: its checkpoint reader and state
    initializer are replaced, so nothing is compiled."""
    cfg = JaxExperimentConfig.from_dict(ExperimentConfig().to_dict())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume=resume, out_dir=str(tmp_path / "jax_run")))
    fake = types.SimpleNamespace(params=dict.fromkeys(ckpt_heads))
    monkeypatch.setattr(jax_multitask, "init_multitask_state", lambda *a, **k: (None,) * 4)
    monkeypatch.setattr(jax_loops, "load_checkpoint", lambda path: (fake, cfg))
    with pytest.raises(ValueError) as e:
        jax_loops.train_multitask(cfg, mesh=object(), logger=object(),
                                  boundary_weight=boundary_weight)
    monkeypatch.undo()
    return str(e.value)


def test_multitask_resume_refusals_carry_the_jax_messages(tmp_path, monkeypatch):
    plain = tmp_path / "adapt"
    _adapt(plain, 1)
    mt = tmp_path / "mt"
    _multitask(mt, 1, "--boundary_weight", "1.0")
    cases = [(str(plain / "last"), ("G", "F1", "F2"), ["--input_ch", "4"], 0.0,
              "is not a multitask checkpoint"),
             (str(mt / "last"), ("G", "F1", "F2", "D", "B"), [], 0.0,
              "boundary-head mismatch — checkpoint has a 'B' subtree but --boundary_weight is unset")]
    for resume, heads, extra, bw, needle in cases:
        want = _jax_resume_refusal(monkeypatch, tmp_path, resume, heads, bw)
        with pytest.raises(ValueError) as ours:
            _multitask(tmp_path / "again", 2, "--resume", resume, *extra)
        assert str(ours.value) == want and needle in want


def test_multitask_late_fusion_refused_before_any_state(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(loops, "create_train_state", lambda *a, **k: built.append(a))
    with pytest.raises(ValueError, match="--fusion late"):
        _multitask(tmp_path / "late", 1, "--fusion", "late", "--input_ch", "6")
    assert not built
