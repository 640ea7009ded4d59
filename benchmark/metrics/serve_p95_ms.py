"""The 95th percentile of the latencies of all the window's requests
(linear interpolation between order statistics): from the call with the
numpy planes to the class map in host memory."""

import numpy as np

UNIT = "ms"


def read(record):
    if record["traffic"]["kind"] != "serve":
        return None
    return float(np.percentile(record["window"]["latencies_s"], 95)) * 1e3
