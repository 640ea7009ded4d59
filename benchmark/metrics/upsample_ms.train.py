"""Device time of the heads' 8x upsample per training iteration: the
kernels launched by the depthwise ``conv_transpose2d`` of both heads and by
the ``ConvolutionBackward0`` nodes that autograd runs for it, found through
the profiler's link from each kernel to the operator that launched it
(``lib/trace.py upsample_seconds``), over the traced iterations."""

LAYER = "heads' upsample"
UNIT = "ms"
MOVES = "train_images_per_s"


def read(record):
    trace = record["trace"]
    if trace is None or record["traffic"]["kind"] != "train" or not trace["upsample_s"]:
        return None
    return 1e3 * trace["upsample_s"] / trace["iterations"]
