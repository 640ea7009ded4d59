"""The device's idle share of the traced stretch that profiled the
device's activity alone: 1 minus the union of the intervals in which an
operation ran on the card (kernels, copies, sets), over the stretch's wall
time, in percent. The stretch that traced the host's operations too is
slowed by that tracing and reads no idle share here."""

LAYER = "device"
UNIT = "%"
MOVES = "train_images_per_s"


def read(record):
    trace = record["trace"]
    if trace is None or record["traffic"]["kind"] != "train":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
