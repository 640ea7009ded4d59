"""Reference-parity evaluation (the JAX package's ``tools/parity_eval.py``):
import a reference torch checkpoint (``cli/import_torch.py``: G/F1/F2,
first-conv widening to ``--input_ch``), then score it on a corpus with
``cli/adapt_test.py``, both on the card.

    python -m mcseg_tpu_torch.tools.parity_eval ref_ckpt.pth.tar \\
        --dataset nyu --data_root /data --net drn_d_38 --input_ch 6 \\
        --n_class 40 [--split val] [--test_img_shape 640 480] [--f1_only]

Prints the import's lines, the per-class IoU table and ``parity mIoU``;
returns the mIoU.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser("parity_eval")
    p.add_argument("torch_checkpoint")
    p.add_argument("--dataset", required=True, help="target corpus (nyu|city|...)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--net", default="drn_d_38")
    p.add_argument("--input_ch", type=int, default=3)
    p.add_argument("--n_class", type=int, default=None)
    p.add_argument("--split", default="val")
    p.add_argument("--test_img_shape", type=int, nargs=2, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="float32 for parity against torch")
    p.add_argument("--f1_only", action="store_true")
    p.add_argument("--outdir", default=None, help="dump label/color PNGs here")
    p.add_argument("--keep_import", default=None,
                   help="write the imported checkpoint to this prefix "
                        "instead of a temporary directory")
    args = p.parse_args(argv)

    from mcseg_tpu_torch.cli import adapt_test, import_torch
    from mcseg_tpu_torch.core.device import resolve_device
    from mcseg_tpu_torch.data.labels import get_label_spec

    resolve_device(device)
    n_class = args.n_class or get_label_spec(args.dataset)[0]
    tmp = None
    if args.keep_import:
        prefix = args.keep_import
    else:
        tmp = tempfile.mkdtemp(prefix="parity_import_")
        prefix = os.path.join(tmp, "imported")
    try:
        import_torch.main([
            args.torch_checkpoint, prefix,
            "--net", args.net, "--input_ch", str(args.input_ch),
            "--n_class", str(n_class), "--dtype", args.dtype,
        ], device=device)
        test_argv = [
            prefix, args.dataset, "--data_root", args.data_root,
            "--split", args.split, "--batch_size", str(args.batch_size),
        ]
        if args.test_img_shape:
            test_argv += ["--test_img_shape", *map(str, args.test_img_shape)]
        if args.f1_only:
            test_argv += ["--f1_only"]
        if args.outdir:
            test_argv += ["--outdir", args.outdir]
        miou = adapt_test.main(test_argv, device=device)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"parity mIoU: {100.0 * miou:.2f}")
    return miou


if __name__ == "__main__":
    main()
