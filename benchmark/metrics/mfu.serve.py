"""Model FLOP utilization of the window: the reference's FLOPs of one
served request (G and one head, forward) times the requests of
the window, over the window's seconds times the bf16 peak (989 TFLOP/s),
in percent. The count is the benchmark's (``lib/flops.py``), not
the program's, so a change to how the program computes a layer leaves it
unchanged."""

from benchmark.lib.peaks import BF16_FLOPS

LAYER = "model G and F"
UNIT = "%"
MOVES = "serve_images_per_s"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    w = record["window"]
    return 100.0 * w["flops"] / (w["window_s"] * BF16_FLOPS)
