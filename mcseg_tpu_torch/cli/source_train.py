"""Source-only training entry point (reference: source_trainer.py).

    python -m mcseg_tpu_torch.cli.source_train nyu --input_ch 6 --net drn_d_38 ...
"""

from mcseg_tpu_torch.cli._train_main import run_training
from mcseg_tpu_torch.cli.argparse_compat import get_src_only_training_parser
from mcseg_tpu_torch.train.loops import train_source


def main(argv=None, device="cuda"):
    """Train from the command line ``argv`` on ``device``; returns the final
    train state."""
    args = get_src_only_training_parser().parse_args(argv)
    return run_training(args, train_source, False, device)


if __name__ == "__main__":
    main()
