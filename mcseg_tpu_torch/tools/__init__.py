"""Host programs: the corpus-preparation tools, which write the on-disk
layouts the readers take (``data/datasets.py``) with the standard-library
PNG encoder (``data/transforms.py``), and the deployment tools
(``export_serving``, ``serve_http``, ``bench_serving``). Each runs as
``python -m mcseg_tpu_torch.tools.<name>``."""
