"""Multitask training entry point: segmentation plus the auxiliary depth
head and, with ``--boundary_weight`` > 0, the boundary head; MCD
adaptation unless ``--source_only``.

    python -m mcseg_tpu_torch.cli.multitask_train suncg nyu --input_ch 3 --depth_weight 0.5 ...
"""

import functools

from mcseg_tpu_torch.cli._train_main import run_training
from mcseg_tpu_torch.cli.argparse_compat import get_da_mcd_training_parser
from mcseg_tpu_torch.train.loops import train_multitask


def get_multitask_training_parser():
    """The MCD training parser plus the multitask flags of the JAX
    package's ``cli/multitask_train.py``."""
    parser = get_da_mcd_training_parser()
    parser.add_argument("--depth_weight", type=float, default=0.5)
    parser.add_argument("--boundary_weight", type=float, default=0.0,
                        help="weight of the auxiliary boundary-detection head "
                             "(0 disables; targets derived from source labels)")
    parser.add_argument("--source_only", action="store_true",
                        help="multitask without MCD adaptation")
    return parser


def main(argv=None, device="cuda"):
    """Train from the command line ``argv`` on ``device``; returns the final
    train state."""
    args = get_multitask_training_parser().parse_args(argv)
    adapt = not args.source_only
    train = functools.partial(train_multitask, depth_weight=args.depth_weight,
                              boundary_weight=args.boundary_weight, adapt=adapt)
    return run_training(args, train, adapt, device)


if __name__ == "__main__":
    main()
