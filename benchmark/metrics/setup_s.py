"""Set-up: from the start of ``benchmark/run.py`` until the window opens
(imports, kernel load or build, weights and inputs from the seed, the
program's state, the first iterations or requests, the FLOP count)."""

UNIT = "s"


def read(record):
    return record["setup_s"]
