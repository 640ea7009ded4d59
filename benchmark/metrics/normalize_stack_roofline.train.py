"""The normalize/stack kernel (``mcseg_tpu_torch/csrc/normalize_stack.cu``)
against its roofline in a training iteration, in percent: the least time
its launch needs at the cell's shapes, the bytes it must move (float32 RGB
crops and HHA/255 read once, the flip flags, the bfloat16 stack written
once; ``lib/flops.py normalize_stack_bytes``) over the card's HBM
bandwidth, divided by the kernel's mean device time per launch in the
trace (two launches an iteration, source and target, of one shape)."""

from benchmark.lib.flops import normalize_stack_bytes
from benchmark.lib.peaks import HBM_BYTES_PER_S
from benchmark.lib.trace import op_time

LAYER = "kernel"
UNIT = "%"
MOVES = "train_images_per_s"
KERNEL = "normalize_stack_kernel"


def read(record):
    trace = record["trace"]
    if trace is None or record["traffic"]["kind"] != "train":
        return None
    seconds, launches = op_time(trace["ops"], KERNEL)
    if not launches:
        return None
    sc = record["traffic"]["scene"]
    nbytes = normalize_stack_bytes(record["traffic"]["batch"], (sc["height"], sc["width"]),
                                   record["config"]["model"]["input_ch"], rgb_bytes=4)
    return 100.0 * nbytes / HBM_BYTES_PER_S / (seconds / launches)
