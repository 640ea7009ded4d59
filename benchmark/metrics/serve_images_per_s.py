"""Serving rate: images of every request completed in the window, over
the window."""

UNIT = "images/s"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    w = record["window"]
    return w["images"] / w["window_s"]
