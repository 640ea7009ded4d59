"""Convert a reference (torch) checkpoint into the port's checkpoint.

Two input layouts, as the JAX package's ``cli/import_torch.py`` takes:

1. A reference training checkpoint ``{epoch, args, g_state_dict,
   f1_state_dict, f2_state_dict, optimizer_g, optimizer_f}``: G, F1 and F2
   are imported (the heads' ``up.``/``upsample`` tensors dropped: the
   port's upsample is fixed).
2. A bare trunk state dict (ImageNet weights; auto-detected, or forced
   with ``--g_only``): G alone is seeded, its ``fc*`` tensors dropped, and
   F1/F2 keep their seed-0 initialization.

The first conv widens to ``--input_ch`` (RGB slice kept, extra channels
the RGB mean; ``utils/torch_import.py``). The torch ``epoch`` does not
become ``step``: step counts iterations for the lr schedule, so an
imported checkpoint starts at 0 and the source epoch is printed.

    python -m mcseg_tpu_torch.cli.import_torch ref_ckpt.pth.tar out_prefix \\
        --net drn_d_38 --input_ch 6 --n_class 40
"""

from __future__ import annotations

import argparse

import torch

from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from mcseg_tpu_torch.core.device import resolve_device
from mcseg_tpu_torch.models.factory import init_models
from mcseg_tpu_torch.train.state import create_train_state
from mcseg_tpu_torch.utils.checkpoint import save_checkpoint
from mcseg_tpu_torch.utils.torch_import import import_torch_state_dict


def _is_bare_state_dict(blob) -> bool:
    """A flat {name: tensor} dict (ImageNet trunk weights) rather than the
    reference's {epoch, args, *_state_dict, optimizer_*} checkpoint."""
    if not isinstance(blob, dict) or not blob:
        return False
    if any(k.endswith("state_dict") for k in blob):
        return False
    return all(hasattr(v, "shape") for v in blob.values())


def main(argv=None, device="cuda"):
    """Import; writes ``<out_prefix>.pt`` and its config from a train
    state built on ``device``; returns the .pt path."""
    p = argparse.ArgumentParser("import_torch")
    p.add_argument("torch_checkpoint")
    p.add_argument("out_prefix")
    p.add_argument("--net", default="drn_d_38")
    p.add_argument("--input_ch", type=int, default=3)
    p.add_argument("--n_class", type=int, default=40)
    p.add_argument("--g_key", default="g_state_dict")
    p.add_argument("--f1_key", default="f1_state_dict")
    p.add_argument("--f2_key", default="f2_state_dict")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="compute dtype written into the imported config "
                        "(float32 for parity evaluations)")
    p.add_argument("--upsample", default="convt", choices=["convt", "resize"])
    p.add_argument("--g_only", action="store_true",
                   help="treat the file as a bare trunk state_dict "
                        "(ImageNet weights); auto-detected when no "
                        "*_state_dict keys are present")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    # a reference checkpoint may hold an ``args`` namespace, so it is
    # unpickled in full: import only files you trust
    blob = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    model_cfg = ModelConfig(net=args.net, input_ch=args.input_ch, n_class=args.n_class,
                            dtype=args.dtype, upsample=args.upsample)
    cfg = ExperimentConfig(model=model_cfg, data=DataConfig(
        input_ch=args.input_ch, n_class=args.n_class), train=TrainConfig())
    params = init_models(model_cfg, torch.Generator().manual_seed(cfg.train.seed))

    if args.g_only or _is_bare_state_dict(blob):
        # the trunk's classification head (fc tensors) is never matched
        sd = {k: v for k, v in blob.items() if not k.startswith("fc")}
        params["G"] = import_torch_state_dict(sd, params["G"])
        print(f"seeded G trunk from bare state_dict ({len(sd)} tensors); "
              f"F1/F2 freshly initialized")
        epoch = None
    else:
        for name, key in (("G", args.g_key), ("F1", args.f1_key), ("F2", args.f2_key)):
            sd = blob.get(key)
            if sd is None:
                print(f"warning: {key!r} not in checkpoint "
                      f"(keys: {sorted(blob)[:10]}); leaving {name} initialized")
                continue
            sd = {k: v for k, v in sd.items() if "up." not in k and "upsample" not in k}
            params[name] = import_torch_state_dict(sd, params[name])
            print(f"imported {name} from {key} ({len(sd)} tensors)")
        epoch = blob.get("epoch")

    state = create_train_state(model_cfg, cfg.train, cfg.train.seed, dev, params=params)
    path = save_checkpoint(args.out_prefix, state, cfg)
    if epoch is not None:
        print(f"note: source checkpoint was at epoch {epoch}; step reset to 0 "
              f"(the LR schedule restarts — step counts iterations, not epochs)")
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
