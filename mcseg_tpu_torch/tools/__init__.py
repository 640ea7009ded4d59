"""Host programs: the corpus-preparation tools, which write the on-disk
layouts the readers take (``data/datasets.py``) with the standard-library
PNG encoder (``data/transforms.py``), the deployment tools
(``export_serving``, ``serve_http``, ``bench_serving``), and the result
tools (``parity_eval``: import a reference checkpoint and score it;
``make_result_sheet``; ``summarize_run``). Each runs as
``python -m mcseg_tpu_torch.tools.<name>``."""
