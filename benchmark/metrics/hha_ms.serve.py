"""Device time of the depth-to-HHA encoding per served request, read from
the program's ``hha`` span: CUDA event to CUDA event, its kernels and the
device's idle between them, over the requests of the traced stretch that
profiled the device alone (``lib/spans.py``)."""

from benchmark.lib.spans import span_ms_per_root

LAYER = "HHA"
UNIT = "ms"
MOVES = "serve_p95_ms"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    return span_ms_per_root(record, "hha")
