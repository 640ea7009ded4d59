"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (``mcseg_tpu_torch``).
The cell, its configuration and its traffic are found by name
(``benchmark/lib/spec.py``); the traffic's ``kind`` picks the driver
(``benchmark/drivers/<kind>.py``). The run: set-up (imports, weights and
inputs from the seed, the first iterations or requests, which warm every
shape up), the window of ``--seconds``, with ``--trace 1`` two profiled
stretches after it (the device alone, then the host's operations too), then the program's state is freed and the reference
checks what the program produced. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit; the same numbers are the last lines of
standard error.

It exits non-zero and prints no result when a configuration or traffic
file holds a key or value that no code reads or implements (exit code 2,
the key named), when CUDA is unavailable or has fewer cards than the cell
asks for, when the program is missing, and when JAX, flax or the JAX
package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache the program or torch keeps goes to a fixed place in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mcseg_tpu"}


def _fail(msg: str, code: int = 3):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules():
    return sorted(FORBIDDEN & {name.split(".")[0] for name in sys.modules})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def read_metrics(spec, cell_name, record, traced):
    from benchmark.lib.spec import metrics_of, reader

    out = {}
    for m in metrics_of(spec, cell_name, traced):
        value = reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(argv=None, device="cuda", wrap=None):
    """One run; returns the result line's object. ``wrap``, for tests,
    wraps the program's entry (``setup``'s wrapper argument)."""
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.lib import check, spec as specs

    spec = specs.benchmark_json()
    cell = specs.cell(spec, args.workload)
    config, traffic = specs.config(cell["config"]), specs.traffic(cell["traffic"])
    try:
        specs.check_config(config, specs.config_entry(spec, cell["config"]))
        drv = specs.driver(traffic.get("kind", ""))
        drv.check_traffic(config, traffic, cell["traffic"])
    except specs.SpecError as e:
        _fail(str(e), code=2)
    print(f"benchmark: {cell['name']}: {config['deployment']}; assumed: "
          f"{'; '.join(config['assumed'])}", file=sys.stderr, flush=True)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            _fail("CUDA is not available")
        if torch.cuda.device_count() < cell["chips"]:
            _fail(f"{cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} visible")
    try:
        import mcseg_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program (mcseg_tpu_torch) is not in this checkout: {e}")
    limits = specs.limits(cell["name"])
    r = drv.Run(config, traffic, args.seed, device)
    imports_s = time.perf_counter() - T0
    r.setup(wrap)
    setup_s = time.perf_counter() - T0
    window = r.window(args.seconds)
    trace = r.trace() if args.trace else None
    peak = max(r.setup_peak, window["window_peak_bytes"])
    r.free()
    numbers = r.check()
    correct, table = check.judge({k: v for k, v in numbers.items() if not k.startswith("_")},
                                 limits)
    found = forbidden_modules()
    if found:
        _fail(f"loaded in this process: {found}")
    record = {"cell": cell, "config": config, "traffic": traffic, "setup_s": setup_s,
              "window": window, "trace": trace}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct and window["failed"] == 0),
           "attempted": window.get("iterations", window.get("requests")),
           "failed": window["failed"],
           "metrics": read_metrics(spec, cell["name"], record, bool(args.trace)),
           "device": dev}
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace["busy_s"], trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
        out["traced_images_per_s"] = trace["images"] / trace["window_s"]
        ht = trace["host_traced"]  # the stretch that traced the host's operations too
        out["host_traced"] = {**ht, "idle_share": 100.0 * (1.0 - ht["busy_s"] / ht["window_s"]),
                              "images_per_s": trace["images"] / ht["window_s"]}
    out["card"] = card_line() if device == "cuda" else device
    out["setup_parts"] = {"imports": imports_s, **r.setup_parts}
    out["memory_peak"] = {"setup_bytes": int(r.setup_peak),
                          "window_bytes": int(window["window_peak_bytes"])}
    out["window"] = {"seconds": window["window_s"], "images": window["images"],
                     "numbers": numbers}
    out["checks"] = table
    return out


def main(argv=None):
    out = run(argv)
    mem = out["memory_peak"]
    print(f"memory peak (torch.cuda.max_memory_allocated): set-up {mem['setup_bytes']} "
          f"bytes, window {mem['window_bytes']} bytes", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
