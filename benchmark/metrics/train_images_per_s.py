"""Training rate: source plus target images of every iteration enqueued in
the window, over the window (its start to the synchronize after the last
iteration)."""

UNIT = "images/s"


def read(record):
    if record["traffic"]["kind"] != "train":
        return None
    w = record["window"]
    return w["images"] / w["window_s"]
