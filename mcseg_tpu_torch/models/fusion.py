"""Late (score) fusion of RGB and HHA branches.

The port of the JAX package's ``models/fusion.py``: two parallel DRN
trunks, one on RGB and one on HHA, each with its own 1x1 head, fused by
adding the class scores. The modules keep the (G, F1, F2) contract, so the
MCD and source steps and the tester take them unchanged; G returns a pair
of feature maps, which each classifier takes as one argument.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from mcseg_tpu_torch.models.drn import build_drn
from mcseg_tpu_torch.models.heads import PixelClassifier


class LateFusionGenerator(nn.Module):
    """Two DRN trunks: [B, 6, H, W] -> (rgb_feat, hha_feat). Channels 0:3
    are RGB and 3:6 HHA (the reference's ``torch.cat([rgb, hha])``)."""

    def __init__(self, net: str = "drn_d_38"):
        super().__init__()
        self.rgb_trunk = build_drn(net, input_ch=3)
        self.hha_trunk = build_drn(net, input_ch=3)
        self.out_dim = self.rgb_trunk.out_dim

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.rgb_trunk(x[:, 0:3]), self.hha_trunk(x[:, 3:6])


class LateFusionClassifier(nn.Module):
    """Classify each branch's features with its own head and sum the
    upsampled logits."""

    def __init__(self, in_ch: int, n_class: int, upsample: str = "convt"):
        super().__init__()
        self.rgb_head = PixelClassifier(in_ch, n_class, upsample=upsample)
        self.hha_head = PixelClassifier(in_ch, n_class, upsample=upsample)

    def forward(self, feats):
        f_rgb, f_hha = feats
        return self.rgb_head(f_rgb) + self.hha_head(f_hha)
