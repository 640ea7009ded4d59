"""Export a checkpoint's serving path as a self-contained artifact.

    python -m mcseg_tpu_torch.tools.export_serving runs/suncg2nyu/last \
        --out model.pt2 --batch 1 --device cuda [--with_probs] \
        [--out_shape H W] [--f1_only]

Writes ``model.pt2`` (``torch.export.save`` of the exported program:
parameters inside, static shapes, the normalize kernel and the heads'
upsample as the custom ops ``mcseg::normalize_stack`` and
``mcseg::upsample_convt``) and ``model.pt2.json`` (the manifest: input
spec, device, torch version, outputs). Load it with:

    from mcseg_tpu_torch.eval.serving import load_serving
    pred = load_serving("model.pt2")({"image": uint8_batch, "depth": metres})

An artifact exported for ``cuda`` runs on a card; one for ``cpu`` runs the
kernels' plain versions. See eval/serving.py.
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None):
    """Export; returns the manifest (a list of them for several sizes).
    ``device``, when given, replaces the default of ``--device``."""
    p = argparse.ArgumentParser(
        "export_serving", description="Export a checkpoint for serving")
    p.add_argument("checkpoint", help="checkpoint prefix (without .pt)")
    p.add_argument("--out", required=True, help="artifact output path")
    p.add_argument("--batch", default="1",
                   help="static batch size of the exported graph; a comma "
                        "list (e.g. 1,8,32) writes one artifact per size "
                        "(<out>.b<N>) for a bucketing server")
    p.add_argument("--device", default=device or "cuda", choices=("cuda", "cpu"),
                   help="device the artifact runs on")
    p.add_argument("--out_shape", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="prediction-map resolution (default: test_img_shape)")
    p.add_argument("--with_probs", action="store_true",
                   help="also return the softmax probability maps")
    p.add_argument("--f1_only", action="store_true",
                   help="serve F1 alone instead of averaging F1/F2")
    p.add_argument("--extra_plane", default=None,
                   choices=("depth", "hha", "ir"),
                   help="non-RGB input plane kind (default: resolved from "
                        "the checkpoint config — must match training)")
    p.add_argument("--no_depth_head", action="store_true",
                   help="multitask checkpoints serve their metric-depth "
                        "map by default; this opts out (pred only)")
    args = p.parse_args(argv)

    from mcseg_tpu_torch.eval.serving import export_serving
    from mcseg_tpu_torch.utils.checkpoint import load_params

    try:
        batches = [int(s) for s in str(args.batch).split(",") if s.strip()]
    except ValueError:
        p.error(f"--batch must be an int or comma list of ints, got {args.batch!r}")
    if not batches:
        p.error(f"--batch parsed to no sizes: {args.batch!r}")
    params, cfg = load_params(args.checkpoint)
    manifests = []
    for b in batches:
        # one artifact per size: a bucketing server picks by request batch
        out = args.out if len(batches) == 1 else f"{args.out}.b{b}"
        manifest = export_serving(
            cfg, params, out, batch=b, device=args.device,
            average_classifiers=not args.f1_only,
            out_shape=tuple(args.out_shape) if args.out_shape else None,
            with_probs=args.with_probs, extra_plane=args.extra_plane,
            with_depth=False if args.no_depth_head else None)
        print(f"wrote {out} ({manifest['bytes']} bytes) device={manifest['device']} "
              f"input={manifest['input_spec']} -> {manifest['output']}", flush=True)
        manifests.append(manifest)
    return manifests[0] if len(manifests) == 1 else manifests


if __name__ == "__main__":
    main()
