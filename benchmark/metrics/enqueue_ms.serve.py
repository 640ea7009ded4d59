"""The host's own time inside the serving entry per request: the host
milliseconds of the program's root span ``serve.request`` (``eval/serving.py
make_serve_fn``'s ``serve``, from the call with the numpy planes to its
return with the class map still on the card) less those of the ``host_wait``
spans inside it (each blocking copy to the card, and each ``eigh``, whose
result the host checks), over the requests of the traced stretch that
profiled the device alone (``lib/spans.py``). What is left is the host's
Python and launches; where it exceeds the device's time of a request, the
host sets the pace."""

from benchmark.lib.spans import first_roots

LAYER = "serve entry"
UNIT = "ms"
MOVES = "serve_p95_ms"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    got = first_roots(record)
    if got is None:
        return None
    n, recs = got
    entry, waits = ([r["host_ms"] for r in recs if r["kind"] == "span" and r["name"] == name]
                    for name in ("serve.request", "host_wait"))
    return (sum(entry) - sum(waits)) / n
