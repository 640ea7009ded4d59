"""The harness on the CPU: the manifest, what it imports, that every piece is
found by name, and that a file the code does not read is refused.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import copy
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.lib import spec as specs
from benchmark.tests import _tiny

BENCH = _tiny.BENCH
REPO = _tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mcseg_tpu"}


def _spec():
    return specs.benchmark_json()


def _fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          check=True, cwd=REPO, timeout=300).stdout


# ---- the manifest ----------------------------------------------------------
def test_manifest_keys_names_and_units():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1] == "benchmark/run.py"
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits into its 43200 s
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = spec["end_to_end"] + spec["per_layer"]
    for entry in spec["configs"] + spec["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    names = [e["name"] for e in metrics]
    assert len(names) == len(set(names))
    for path in spec["paths"]:
        for _, _, files in os.walk(os.path.join(REPO, path)):
            for f in files:
                assert re.match(r"^[A-Za-z0-9_.-]+$", f), f


def test_every_piece_is_found_by_name_and_validates():
    """Each cell's configuration, traffic, limits, driver and metric readers
    are files named after it, and each file passes its schema."""
    spec = _spec()
    for w in spec["workloads"]:
        config, traffic = specs.config(w["config"]), specs.traffic(w["traffic"])
        specs.check_config(config, specs.config_entry(spec, w["config"]))
        specs.driver(traffic["kind"]).check_traffic(config, traffic, w["traffic"])
        assert specs.limits(w["name"])
        for traced in (False, True):
            for m in specs.metrics_of(spec, w["name"], traced):
                assert hasattr(specs.reader(m["name"]), "read")
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert c["file"] == f"benchmark/configs/{c['name']}.json"


def test_each_per_layer_metric_moves_what_its_cells_report():
    spec = _spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in specs.metrics_of(spec, cell, False)}, \
                (m["name"], cell)
    for w in spec["workloads"]:
        untraced = {x["name"] for x in specs.metrics_of(spec, w["name"], False)}
        assert "setup_s" in untraced and len(untraced) >= 2
        assert specs.metrics_of(spec, w["name"], True)
    for m in spec["end_to_end"] + spec["per_layer"]:
        r = specs.reader(m["name"])
        assert r.UNIT == m["unit"], m["name"]
        if m in spec["per_layer"]:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), m["name"]


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries, with no edit to a file that is there."""
    root = _tiny.make_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny_d22.json")) as f:
        config = json.load(f)
    config["name"] = "added_model"
    with open(os.path.join(bench, "configs", "added_model.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench, "traffic", "tiny_serve_b8_closed.json")) as f:
        traffic = json.load(f)
    traffic["pool"] = 2
    with open(os.path.join(bench, "traffic", "added_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "metrics", "added_requests.py"), "w") as f:
        f.write('LAYER = "serve entry"\nUNIT = "count"\nMOVES = "serve_images_per_s"\n\n\n'
                'def read(record):\n    return record["window"]["requests"]\n')
    with open(os.path.join(bench, "limits", "added_model.added_mix.json"), "w") as f:
        json.dump({"limits": {"logit_gap": 1e9}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({**spec["configs"][0], "name": "added_model",
                            "file": "benchmark/configs/added_model.json"})
    spec["workloads"].append({"name": "added_model.added_mix", "config": "added_model",
                              "traffic": "added_mix", "chips": 1, "why": "added"})
    spec["end_to_end"][1]["workloads"].append("added_model.added_mix")
    spec["per_layer"].append({"name": "added_requests", "unit": "count", "better": "higher",
                              "source": "host_clock", "layer": "serve entry",
                              "moves": "serve_images_per_s",
                              "workloads": ["added_model.added_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    code = ("import sys, json\nsys.path.insert(0, sys.argv[1])\n"
            "from benchmark.lib import spec as s\n"
            "sp = s.benchmark_json()\n"
            "cell = s.cell(sp, 'added_model.added_mix')\n"
            "c, t = s.config(cell['config']), s.traffic(cell['traffic'])\n"
            "s.check_config(c, s.config_entry(sp, cell['config']))\n"
            "s.driver(t['kind']).check_traffic(c, t, cell['traffic'])\n"
            "print(json.dumps([c['name'], t['pool'],"
            " [m['name'] for m in s.metrics_of(sp, cell['name'], True)],"
            " s.reader('added_requests').read({'window': {'requests': 7}}),"
            " s.driver(t['kind']).__name__]))\n")
    out = subprocess.run([sys.executable, "-c", code, root], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    assert json.loads(out) == ["added_model", 2, ["added_requests"], 7, "benchmark.drivers.serve"]


# ---- files the code does not read are refused -------------------------------
def _edit(obj, path, value):
    """``obj`` with the key at ``path`` (keys joined by '.') set to
    ``value``, or removed where ``value`` is ``...``."""
    obj = copy.deepcopy(obj)
    *parents, last = path.split(".")
    node = obj
    for p in parents:
        node = node[p]
    if value is ...:
        del node[last]
    else:
        node[last] = value
    return obj


CONFIG_CASES = [
    ("model.arch", "C", "'model.arch'"), ("model.upsample", "resize", "'model.upsample'"),
    ("model.heads", 1, "'model.heads'"), ("model.dtype", "float16", "'model.dtype'"),
    ("model.input_ch", 4, "'model.input_ch'"), ("model.width_mult", 2, "'model.width_mult'"),
    ("program.checkpoint", "x", "'program.checkpoint'"), ("label_map", ..., "'label_map'"),
    ("source", "https://example.org", "'source'"), ("reduced", ["layers"], "'reduced'"),
]


@pytest.mark.parametrize("path,value,named", CONFIG_CASES)
def test_config_file_key_not_read_is_refused(path, value, named):
    spec = _spec()
    config = _edit(specs.config("drn_d_38_rgbhha"), path, value)
    with pytest.raises(specs.SpecError, match=re.escape(named)):
        specs.check_config(config, specs.config_entry(spec, "drn_d_38_rgbhha"))


TRAFFIC_CASES = [
    ("mcd_train_b24_640x480", "clients", 4, "'clients'"),
    ("mcd_train_b24_640x480", "train.random_flip", False, "'train.random_flip'"),
    ("mcd_train_b24_640x480", "train.num_k", 0, "'train.num_k'"),
    ("mcd_train_b24_640x480", "scene.depth", False, "'scene.depth'"),
    ("mcd_train_b24_640x480", "scene.classes", [1, 41], "'scene.classes'"),
    ("mcd_train_b24_640x480", "scene.width", ..., "'scene.width'"),
    ("mcd_train_b24_640x480", "pool", 2, "'pool'"),
    ("serve_b8_closed", "clients", 4, "'clients'"),
    ("serve_b8_closed", "rate_hz", 10.0, "'rate_hz'"),
    ("serve_b8_closed", "shift", {"request": 1.0}, "'shift'"),
    ("serve_b8_closed", "kind", "open_loop", "'kind'"),
    ("serve_b8_closed", "kind", "train", "'train'"),
    ("serve_b8_closed", "scene.void_share", 1.5, "'scene.void_share'"),
]


@pytest.mark.parametrize("name,path,value,named", TRAFFIC_CASES)
def test_traffic_file_key_not_read_is_refused(name, path, value, named):
    traffic = _edit(specs.traffic(name), path, value)
    config = specs.config("drn_d_38_rgbhha")
    with pytest.raises(specs.SpecError, match=re.escape(named)):
        specs.driver(traffic["kind"]).check_traffic(config, traffic, name)


def test_traffic_kind_without_a_driver_is_refused():
    with pytest.raises(specs.SpecError, match="'kind'"):
        specs.driver("open_loop")


def test_run_refuses_an_unread_key_before_measuring(tmp_path):
    """run.py stops with exit code 2 and no result line, naming the key."""
    root = _tiny.make_checkout(str(tmp_path))
    path = os.path.join(root, "benchmark", "traffic", "tiny_serve_b8_closed.json")
    with open(path) as f:
        traffic = json.load(f)
    traffic["clients"] = 4
    with open(path, "w") as f:
        json.dump(traffic, f)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", _tiny.SERVE_CELL, "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=root,
        timeout=300)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout.strip() == ""
    assert "'clients'" in proc.stderr


# ---- isolation --------------------------------------------------------------
def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    """By top-level name, compared whole: ``mcseg_tpu_torch`` (the program)
    is not ``mcseg_tpu`` (the JAX package). Only run.py and the drivers, which run the
    program, and the tests name the program; the reference, the metric
    arithmetic and the readers do not."""
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, BENCH)
            for mod in _imports(path):
                top = mod.split(".")[0]
                assert top not in FORBIDDEN, (rel, mod)
                if top == "mcseg_tpu_torch":
                    assert rel.startswith(("drivers", "tests", "run.py")), (rel, mod)


def test_isolation_in_a_fresh_interpreter():
    """Importing the harness, the drivers, every reader and the reference
    loads none of JAX, flax, optax or the JAX package; the reference and the
    readers load nothing of the program."""
    code = (
        "import glob, json, os, sys\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.reference.drn, benchmark.reference.hha, benchmark.reference.mcd\n"
        "import benchmark.reference.preprocess, benchmark.reference.quant\n"
        "from benchmark.lib import spec, flops, trace, check\n"
        "for m in glob.glob('benchmark/metrics/*.py'):\n"
        "    spec.reader(os.path.basename(m)[:-3])\n"
        "before = sorted({k.split('.')[0] for k in sys.modules})\n"
        "import benchmark.run, benchmark.drivers.train, benchmark.drivers.serve\n"
        "import benchmark.calibrate\n"
        "after = sorted({k.split('.')[0] for k in sys.modules})\n"
        "print(json.dumps([before, after]))\n")
    before, after = json.loads(_fresh(code))
    assert not set(after) & FORBIDDEN
    assert "mcseg_tpu_torch" not in before
    assert "benchmark" in after


def test_run_names_what_it_found_loaded():
    code = ("import sys, types\n"
            "sys.modules['jax.numpy'] = types.ModuleType('jax.numpy')\n"
            "sys.modules['mcseg_tpu_torch_x'] = types.ModuleType('x')\n"
            "sys.modules['mcseg_tpu_torch'] = types.ModuleType('y')\n"
            "from benchmark import run\n"
            "print(run.forbidden_modules())\n")
    assert _fresh(code).strip() == "['jax']"


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "drn_d_38_rgbhha.serve_b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
