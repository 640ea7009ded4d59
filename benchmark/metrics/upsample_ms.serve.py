"""Device time of the head's 8x upsample per served request (forward
only): the kernels launched by the depthwise ``conv_transpose2d``, found
as ``upsample_ms.train`` finds them, over the traced requests."""

LAYER = "heads' upsample"
UNIT = "ms"
MOVES = "serve_images_per_s"


def read(record):
    trace = record["trace"]
    if trace is None or record["traffic"]["kind"] != "serve" or not trace["upsample_s"]:
        return None
    return 1e3 * trace["upsample_s"] / trace["requests"]
