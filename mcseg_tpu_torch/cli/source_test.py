"""Source-only-checkpoint evaluation entry point (reference:
source_tester.py): adapt_test scoring with F1 alone; --use_f2 averages F1
and F2."""

from mcseg_tpu_torch.cli import adapt_test


def main(argv=None, device="cuda"):
    """Score a checkpoint on ``device``; returns the mIoU."""
    return adapt_test.main(argv, average_classifiers=False, device=device)


if __name__ == "__main__":
    main()
