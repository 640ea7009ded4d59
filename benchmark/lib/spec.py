"""Finding a cell's pieces by name, and refusing a file the code does not read.

``BENCHMARK.json`` at the checkout's root names the cells; a cell names a
configuration and a traffic mix, each a file of its own:

  benchmark/configs/<config>.json     the model's sizes, its label map and
                                      the program's names for it
  benchmark/traffic/<traffic>.json    ``kind`` (the driver module
                                      ``benchmark/drivers/<kind>.py``) and
                                      its parameters
  benchmark/limits/<cell>.json        the limit of each number that the
                                      correctness check compares
  benchmark/metrics/<metric>.py       one reader per metric: ``UNIT`` (and
                                      a per-layer metric's ``LAYER`` and
                                      ``MOVES``), ``read(record)``

Adding a model, a mix, a cell or a metric adds files and entries; no file
that is there changes.

Every key of a configuration or traffic file is read. ``validate`` holds a
file against a schema before anything is measured: a key the schema does
not know, a key it needs and does not find, or a value that the code does
not implement stops the run with a message that names the key.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(ValueError):
    """A configuration or traffic file that the benchmark does not implement."""


def _json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_json(root: str = ROOT) -> Dict:
    return _json(root, "BENCHMARK.json")


def cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _json(bench_dir, "configs", f"{name}.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    return _json(bench_dir, "traffic", f"{name}.json")


def limits(cell_name: str, bench_dir: str = BENCH_DIR) -> Dict[str, float]:
    return _json(bench_dir, "limits", f"{cell_name}.json")["limits"]


def driver(kind: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    if not os.path.exists(os.path.join(bench_dir, "drivers", f"{kind}.py")):
        raise SpecError(f"traffic key 'kind': no driver benchmark/drivers/{kind}.py")
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    """The reader module of ``metric`` (its file name is the metric's)."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(spec: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The metrics a run of ``cell_name`` reports: the end-to-end metrics
    untraced, the per-layer ones traced. A metric with ``workloads`` is
    the listed cells'; one without is every cell's that reports the
    end-to-end metric it ``moves`` (end-to-end: every cell's)."""
    e2e = [m for m in spec["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [cell_name] if m["moves"] in mine else [])]


# ---- schemas ---------------------------------------------------------------
# A rule is a type (bool, int, float, str: float takes an int too), a tuple
# of the values the code implements, a dict (a nested section), a list of
# one rule (a list whose items all follow it), or a callable that returns an
# error message or None.

def positive(kind) -> Any:
    def check(v):
        return _check(v, kind, "") or (None if v > 0 else "must be positive")
    return check


def share(v) -> Any:
    return _check(v, float, "") or (None if 0 <= v < 1 else "must lie in [0, 1)")


def _first_error(errors):
    return next((e for e in errors if e), None)


def _check(v, rule, where: str):
    if isinstance(rule, dict):
        return _validate(v, rule, where)
    if isinstance(rule, tuple):
        return None if v in rule else f"{v!r} is not implemented (the code runs {list(rule)})"
    if isinstance(rule, list):
        if not isinstance(v, list):
            return "must be a list"
        return _first_error([_check(x, rule[0], where) for x in v])
    if rule is float:
        ok = isinstance(v, (int, float)) and not isinstance(v, bool)
        return None if ok else "must be a number"
    if rule in (bool, int, str):
        ok = isinstance(v, rule) and (rule is bool or not isinstance(v, bool))
        return None if ok else f"must be {rule.__name__}"
    return rule(v)


def _validate(obj, schema: Dict, where: str):
    if not isinstance(obj, dict):
        return f"{where or 'file'}: must be an object"
    for key in obj:
        if key not in schema:
            return (f"key {where + key!r} is not read by the benchmark (it reads "
                    f"{sorted(schema)})")
    for key, rule in schema.items():
        if key not in obj:
            return f"key {where + key!r} is missing"
        err = _check(obj[key], rule, f"{where}{key}.")
        if err:
            return err if err.startswith("key ") else f"key {where + key!r}: {err}"
    return None


def validate(obj: Dict, schema: Dict, what: str) -> None:
    """Raise ``SpecError`` naming the first key of ``obj`` that ``schema``
    does not know, lacks, or whose value the code does not implement."""
    err = _validate(obj, schema, "")
    if err:
        raise SpecError(f"{what}: {err}")


def label_map(v):
    if not isinstance(v, dict) or not v:
        return "must map raw ids to train ids"
    for raw, train in v.items():
        if not (raw.isdigit() and 0 <= int(raw) < 255 and isinstance(train, int)
                and 0 <= train < 255):
            return f"entry {raw!r}: {train!r} must map a raw id 0-254 to a train id 0-254"
    return None


MODEL = {"block": ("basic", "bottleneck"), "layers": [positive(int)],
         "channels": [positive(int)], "input_ch": (3, 6), "n_class": positive(int),
         "dtype": ("bfloat16", "float32", "float64")}
CONFIG = {"name": str, "source": str, "reduced": [str], "assumed": [str], "deployment": str,
          "model": MODEL, "program": {"net": str, "src_dataset": str, "tgt_dataset": str},
          "label_map": label_map}


def check_config(cfg: Dict, entry: Dict) -> None:
    """``cfg`` (a configuration file) against the schema and against its
    entry in ``BENCHMARK.json``: the same name, source and ``reduced``."""
    what = f"configs/{entry['name']}.json"
    validate(cfg, CONFIG, what)
    for key in ("name", "source", "reduced"):
        if cfg[key] != entry[key]:
            raise SpecError(f"{what}: key {key!r} is {cfg[key]!r}, BENCHMARK.json says "
                            f"{entry[key]!r}")
    m = cfg["model"]
    if len(m["layers"]) != 8 or len(m["channels"]) != 8:
        raise SpecError(f"{what}: keys 'model.layers' and 'model.channels' must have the "
                        "8 levels of DRN arch D")
    if m["n_class"] != len(set(cfg["label_map"].values())) or \
            set(cfg["label_map"].values()) != set(range(m["n_class"])):
        raise SpecError(f"{what}: key 'label_map' must map onto train ids 0..n_class-1")


def config_entry(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
