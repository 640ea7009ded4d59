"""The port stands alone: importing every module of ``mcseg_tpu_torch``
(the command-line entry points and their console-script shims included)
loads neither ``jax`` nor ``mcseg_tpu``, nor PIL (the readers import it
only on their fallback route), builds nothing (registering the normalize
kernel's custom op included), and its entry points (serving and its export,
evaluation, the three trainers, the five commands, the serving bench, the
reference import, ``evaluate_preds`` and ``parity_eval``) refuse to run on
a CUDA device that is not there (no silent CPU fallback).

Runs in a fresh interpreter, since this test process has JAX loaded."""

import importlib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import torch
import mcseg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(mcseg_tpu_torch.__path__, "mcseg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mcseg_tpu", "PIL",
                                         "tensorboard", "msgpack"))
assert not leaked, leaked
from mcseg_tpu_torch import native
assert native.build_report() == {}, native.build_report()  # nothing built at import
assert len(mods) >= 44, mods
assert {"mcseg_tpu_torch._scripts", "mcseg_tpu_torch.cli.adapt_train",
        "mcseg_tpu_torch.cli.adapt_test", "mcseg_tpu_torch.cli.source_train",
        "mcseg_tpu_torch.cli.source_test", "mcseg_tpu_torch.cli.multitask_train",
        "mcseg_tpu_torch.train.multitask", "mcseg_tpu_torch.eval.depth_metrics",
        "mcseg_tpu_torch.native", "mcseg_tpu_torch.data.disk_cache",
        "mcseg_tpu_torch.data.device_corpus", "mcseg_tpu_torch.eval.serving",
        "mcseg_tpu_torch.tools.export_serving", "mcseg_tpu_torch.tools.serve_http",
        "mcseg_tpu_torch.tools.bench_serving", "mcseg_tpu_torch.utils.msgpack_compat",
        "mcseg_tpu_torch.utils.torch_import", "mcseg_tpu_torch.cli.import_torch",
        "mcseg_tpu_torch.cli.evaluate_preds", "mcseg_tpu_torch.tools.make_result_sheet",
        "mcseg_tpu_torch.tools.summarize_run", "mcseg_tpu_torch.tools.parity_eval"} <= set(mods), mods
from mcseg_tpu_torch.utils import cuda_build
assert cuda_build.load.cache_info().currsize == 0  # registering the op built nothing
assert hasattr(torch.ops.mcseg, "normalize_stack")

from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
from mcseg_tpu_torch.eval.serving import export_serving, make_serve_fn
from mcseg_tpu_torch.tools import bench_serving, parity_eval
from mcseg_tpu_torch.eval.tester import evaluate
from mcseg_tpu_torch.models.factory import init_models
from mcseg_tpu_torch.cli import (adapt_test, adapt_train, evaluate_preds, import_torch,
                                 multitask_train, source_test, source_train)
from mcseg_tpu_torch.train.loops import train_adapt, train_multitask, train_source
from mcseg_tpu_torch.train.state import create_train_state

cfg = ExperimentConfig(model=ModelConfig(net="drn_d_14", input_ch=6, n_class=8),
                       data=DataConfig(tgt_dataset="synthetic_shifted",
                                       test_img_shape=(16, 16), input_ch=6))
params = init_models(cfg.model, torch.Generator().manual_seed(0))
if not torch.cuda.is_available():
    for call in (lambda: make_serve_fn(cfg, params),
                 lambda: make_serve_fn(cfg, params, device="cuda"),
                 lambda: evaluate(params, cfg, max_batches=1),
                 lambda: train_adapt(cfg),
                 lambda: train_source(cfg),
                 lambda: train_multitask(cfg),
                 lambda: train_multitask(cfg, boundary_weight=1.0, adapt=False),
                 lambda: make_serve_fn(cfg, params, with_depth=True),
                 lambda: create_train_state(cfg.model, cfg.train),
                 lambda: adapt_train.main(["synthetic", "synthetic_shifted",
                                           "--out_dir", "/nonexistent/never_written"]),
                 lambda: source_train.main(["synthetic",
                                            "--out_dir", "/nonexistent/never_written"]),
                 lambda: multitask_train.main(["synthetic", "synthetic_shifted",
                                               "--out_dir", "/nonexistent/never_written"]),
                 lambda: adapt_test.main(["/nonexistent/never_read"]),
                 lambda: source_test.main(["/nonexistent/never_read"]),
                 lambda: export_serving(cfg, params, "/nonexistent/never_written"),
                 lambda: bench_serving.main(["--net", "drn_d_14"]),
                 lambda: import_torch.main(["/nonexistent/never_read", "/nonexistent/never"]),
                 lambda: evaluate_preds.main(["/nonexistent/preds", "/nonexistent/gt"]),
                 lambda: parity_eval.main(["/nonexistent/never_read", "--dataset", "nyu",
                                           "--data_root", "/nonexistent/root"])):
        try:
            call()
        except RuntimeError as e:
            assert "CUDA is not available" in str(e), e
        else:
            raise AssertionError("entry point ran without CUDA")
print("ISOLATED", len(mods))
"""


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED" in out.stdout


def test_torch_console_scripts_resolve():
    """Every ``mcseg-torch-*`` entry of pyproject.toml's [project.scripts]
    names a callable of the port's shim module, one per command."""
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        body = f.read()
    block = re.search(r"\[project\.scripts\]\n((?:[^\[\n][^\n]*\n)+)", body).group(1)
    entries = dict(re.findall(r'^(mcseg-torch-[\w-]+) = "([\w.]+:\w+)"', block, re.M))
    assert sorted(entries) == ["mcseg-torch-adapt-test", "mcseg-torch-adapt-train",
                               "mcseg-torch-bench-serving", "mcseg-torch-evaluate-preds",
                               "mcseg-torch-export-serving", "mcseg-torch-import-torch",
                               "mcseg-torch-multitask-train", "mcseg-torch-serve",
                               "mcseg-torch-source-test", "mcseg-torch-source-train",
                               "mcseg-torch-summarize-run"]
    for script, target in entries.items():
        module, attr = target.split(":")
        assert module == "mcseg_tpu_torch._scripts", script
        assert callable(getattr(importlib.import_module(module), attr)), script
