"""MCD adaptation training entry point (reference: adapt_trainer.py).

    python -m mcseg_tpu_torch.cli.adapt_train suncg nyu --input_ch 6 --num_k 4 ...
"""

from mcseg_tpu_torch.cli._train_main import run_training
from mcseg_tpu_torch.cli.argparse_compat import get_da_mcd_training_parser
from mcseg_tpu_torch.train.loops import train_adapt


def main(argv=None, device="cuda"):
    """Train from the command line ``argv`` on ``device``; returns the final
    train state."""
    args = get_da_mcd_training_parser().parse_args(argv)
    return run_training(args, train_adapt, True, device)


if __name__ == "__main__":
    main()
