"""Console-script shims of the ``mcseg-torch-*`` commands.

The setuptools wrapper runs ``sys.exit(target())``; the test mains return
the mIoU and the export tool its manifest, which ``sys.exit`` would print
and turn into status 1. Each shim
runs its main on the card and exits 0 (argparse errors and exceptions keep
their own statuses).
"""

from __future__ import annotations


def source_train():
    from mcseg_tpu_torch.cli import source_train as m

    m.main()
    return 0


def adapt_train():
    from mcseg_tpu_torch.cli import adapt_train as m

    m.main()
    return 0


def multitask_train():
    from mcseg_tpu_torch.cli import multitask_train as m

    m.main()
    return 0


def source_test():
    from mcseg_tpu_torch.cli import source_test as m

    m.main()
    return 0


def adapt_test():
    from mcseg_tpu_torch.cli import adapt_test as m

    m.main()
    return 0


def export_serving():
    from mcseg_tpu_torch.tools import export_serving as m

    m.main()
    return 0


def serve_http():
    from mcseg_tpu_torch.tools import serve_http as m

    m.main()
    return 0


def bench_serving():
    from mcseg_tpu_torch.tools import bench_serving as m

    m.main()
    return 0


def evaluate_preds():
    from mcseg_tpu_torch.cli import evaluate_preds as m

    m.main()
    return 0


def import_torch():
    from mcseg_tpu_torch.cli import import_torch as m

    m.main()
    return 0


def summarize_run():
    from mcseg_tpu_torch.tools import summarize_run as m

    m.main()
    return 0
