"""Host-to-card copies that the host waits for, per served request: the
program's counter ``h2d_blocking`` (``core/device.py to_device``), over the
requests of the traced stretch that profiled the device alone
(``lib/spans.py``)."""

from benchmark.lib.spans import count_per_root

LAYER = "host-to-card"
UNIT = "count"
MOVES = "serve_p95_ms"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    return count_per_root(record, "h2d_blocking")
