"""Device time of the train preprocess of both batches (label remap, HHA where
the configuration has it, crops, the normalize/stack kernel), from an
iteration's start to the program's preprocess mark: CUDA events recorded at
the marks, averaged over the traced iterations."""

LAYER = "train preprocess"
UNIT = "ms"
MOVES = "train_images_per_s"
STAGES = ("preprocess",)


def read(record):
    trace = record["trace"]
    if trace is None or "stage_ms" not in trace:
        return None
    return sum(trace["stage_ms"][s] for s in STAGES)
