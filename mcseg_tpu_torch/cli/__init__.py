"""Command-line entry points with the reference's flags (``argparse_compat``).

    python -m mcseg_tpu_torch.cli.adapt_train SRC TGT [flags]
    python -m mcseg_tpu_torch.cli.adapt_test CHECKPOINT [TGT] [flags]
    python -m mcseg_tpu_torch.cli.source_train SRC [flags]
    python -m mcseg_tpu_torch.cli.source_test CHECKPOINT [TGT] [flags]
    python -m mcseg_tpu_torch.cli.multitask_train SRC TGT [flags]

Each ``main(argv=None, device="cuda")`` runs on the card; callers pass
``device="cpu"`` to run on the CPU. Importing the package has no side
effects.
"""
