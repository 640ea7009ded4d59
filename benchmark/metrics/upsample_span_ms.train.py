"""Device time of the heads' 8x upsample per training iteration, read from
the program's own ``upsample`` spans (``ops/upsample.py upsample_logits``),
forward and backward: CUDA event to CUDA event around each, summed over the
iterations of the traced stretch that profiled the device alone, over
those iterations (``lib/spans.py``). The spans hold the same work whatever
computes the upsample; ``upsample_ms.train`` finds it by its operator."""

from benchmark.lib.spans import span_ms_per_root

LAYER = "heads' upsample"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(record):
    if record["traffic"]["kind"] != "train":
        return None
    return span_ms_per_root(record, "upsample")
