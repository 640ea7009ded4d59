"""Device time of the head's 8x upsample per served request (forward
only), read from the program's own ``upsample`` spans: CUDA event to CUDA
event around each, over the requests of the traced stretch that profiled
the device alone (``lib/spans.py``); ``upsample_ms.serve`` finds the same
work by its operator."""

from benchmark.lib.spans import span_ms_per_root

LAYER = "heads' upsample"
UNIT = "ms"
MOVES = "serve_images_per_s"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    return span_ms_per_root(record, "upsample")
