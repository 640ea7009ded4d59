"""Corpus-preparation tools: host programs that write the on-disk layouts
the readers take (``data/datasets.py``), with the standard-library PNG
encoder (``data/transforms.py``). Each runs as ``python -m
mcseg_tpu_torch.tools.<name>``."""
