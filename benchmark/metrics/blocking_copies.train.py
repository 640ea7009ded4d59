"""Host-to-card copies that the host waits for, per training iteration: the
program's counter ``h2d_blocking`` (``core/device.py to_device``: a copy
that is not ``non_blocking``, or from memory that is not pinned), over the
iterations of the traced stretch that profiled the device alone
(``lib/spans.py``). Each such copy synchronizes the stream, so the card
drains its queue and idles while the host enqueues what follows."""

from benchmark.lib.spans import count_per_root

LAYER = "host-to-card"
UNIT = "count"
MOVES = "train_images_per_s"


def read(record):
    if record["traffic"]["kind"] != "train":
        return None
    return count_per_root(record, "h2d_blocking")
