"""Device time of step C x num_k, from the B mark to the C mark: CUDA events
recorded at the marks, averaged over the traced iterations."""

LAYER = "MCD step"
UNIT = "ms"
MOVES = "train_images_per_s"
STAGES = ("C",)


def read(record):
    trace = record["trace"]
    if trace is None or "stage_ms" not in trace:
        return None
    return sum(trace["stage_ms"][s] for s in STAGES)
