"""Device time of the depth-to-HHA encoding per training iteration (source
and target batch), read from the program's ``hha`` spans (``ops/hha.py
depth_to_hha_batch``): CUDA event to CUDA event, so its kernels and the
device's idle between them (HHA is many small launches), over the
iterations of the traced stretch that profiled the device alone
(``lib/spans.py``). None in a cell without HHA."""

from benchmark.lib.spans import span_ms_per_root

LAYER = "HHA"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(record):
    if record["traffic"]["kind"] != "train":
        return None
    return span_ms_per_root(record, "hha")
