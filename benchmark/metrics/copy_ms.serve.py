"""Host <-> card copies of a request: the device time of the trace's
``Memcpy HtoD`` and ``Memcpy DtoH`` rows (the raw planes in, through
``eval/tester.py batch_to_device``, and the class map out), per request of
the traced stretch."""

from benchmark.lib.trace import op_time

LAYER = "host-to-card"
UNIT = "ms"
MOVES = "serve_p95_ms"


def read(record):
    trace = record["trace"]
    if trace is None or record["traffic"]["kind"] != "serve":
        return None
    seconds = sum(op_time(trace["ops"], d)[0] for d in ("Memcpy HtoD", "Memcpy DtoH"))
    return 1e3 * seconds / trace["requests"]
