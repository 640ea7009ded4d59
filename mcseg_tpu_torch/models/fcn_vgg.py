"""FCN8s on a VGG16 trunk (``--net fcn8s_vgg16``, also ``fcn`` / ``fcn8s``).

The port of the JAX package's ``models/fcn_vgg.py``. G is the VGG16 conv
trunk plus FCN's convolutionalized fc layers and returns the three skip
features (pool3 /8, pool4 /16, drop7 /32); F scores each, fuses coarse to
fine with 2x upsamples and upsamples 8x to full resolution (Long et al.).

  * Each conv is 3x3 with bias and padding 1, then ReLU; each stage ends in
    a 2x2/2 max pool in ceil mode (flax's ``SAME`` pool pads -inf at the
    end, so an odd extent keeps its last row or column).
  * ``conv6`` (7x7 -> 4096, padding 3) and ``conv7`` (1x1 -> 4096), each
    followed by ReLU and ``Dropout`` (keep 0.5, survivors scaled by 2).
  * The decoder crops each 2x upsample to its skip's extent before the
    add: a no-op at /32-divisible sizes.

Under spatial partitioning in training (``parallel/spatial.py``, H a
multiple of 32 x the row blocks) every conv is a ``models.drn.Conv2d``
that takes its halo rows from the neighbouring blocks (``conv6``'s 3 rows
may span several one-row blocks at /32), every pool stays within a block
(each block has an even number of rows at every level and starts on an
even row), and the decoder's 2x and 8x upsamples take the layout
(``FCN8sClassifier`` is a ``RowSplit``), its skips then the same rows.

Submodules are named after the flax tree (``conv1_1`` .. ``conv5_3``,
``conv6``, ``conv7``, ``score7/4/3``), so ``utils/jax_weights.py`` maps
JAX weights by name. The JAX package's ``--s2d`` packed stage 1 computes
the same function in a TPU layout; the port ignores the flag.

Dropout never draws from torch's global generator. In train mode each
``Dropout`` takes its keep-mask from the mask source set on it
(``set_mask_source``): the train state's ``SeededMasks``, reseeded from
(seed, step) at the start of every iteration, or ``GivenMasks`` in tests.
A ``Dropout`` in train mode without a source raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mcseg_tpu_torch.models.drn import Conv2d
from mcseg_tpu_torch.ops.upsample import upsample_logits
from mcseg_tpu_torch.parallel.mesh import DataParallel, batch_rows
from mcseg_tpu_torch.parallel.spatial import RowSplit

VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))  # (convs, channels)
KEEP = 0.5  # Dropout(0.5): keep probability
_DROPOUT_STREAM = 1  # tells the dropout seeds apart from the augment draws'

MaskSource = Callable[[Tuple[int, ...], torch.device], torch.Tensor]


class SeededMasks:
    """The train state's mask source: keep-masks drawn on ``device`` from a
    ``torch.Generator`` that ``reseed(step)`` seeds from (seed, step), so a
    resumed run draws the masks an uninterrupted one drew. Within an
    iteration the generator advances in call order. Under a data-parallel
    context ``data_parallel`` every rank draws the mask of the global batch
    and keeps its data block's images (``parallel.mesh.batch_rows``) and,
    under spatial partitioning, its row block of them, so every rank's
    masks are its share of a single process's."""

    def __init__(self, seed: int, device, data_parallel: Optional[DataParallel] = None):
        self.seed, self.device = seed, torch.device(device)
        self.data_parallel = data_parallel
        self.reseed(0)

    def reseed(self, step: int) -> None:
        mixed = np.random.SeedSequence([self.seed, step, _DROPOUT_STREAM]).generate_state(
            1, np.uint64)[0]
        self.gen = torch.Generator(self.device).manual_seed(int(mixed) & (2**63 - 1))

    def __call__(self, shape, device) -> torch.Tensor:
        dp = self.data_parallel
        if dp is None:
            return torch.rand(shape, generator=self.gen, device=device) < KEEP
        full = (shape[0] * dp.data_blocks, shape[1], shape[2] * dp.space) + tuple(shape[3:])
        images = batch_rows(dp, full[0])
        keep = torch.rand(full, generator=self.gen, device=device) < KEEP
        keep = keep[int(images[0]):int(images[-1]) + 1]
        return keep.narrow(2, dp.space_rank * shape[2], shape[2])


class GivenMasks:
    """Hands out the given keep-masks (bool, NCHW) in call order; the
    count of those handed out is ``drawn``."""

    def __init__(self, masks: Sequence[torch.Tensor]):
        self.masks, self.drawn = list(masks), 0

    def reseed(self, step: int) -> None:
        del step  # the order of the calls alone picks the mask

    def __call__(self, shape, device) -> torch.Tensor:
        if self.drawn == len(self.masks):
            raise IndexError(f"all {len(self.masks)} given dropout masks are drawn")
        mask = self.masks[self.drawn]
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"dropout mask {self.drawn} is {tuple(mask.shape)}, "
                             f"the activation {tuple(shape)}")
        self.drawn += 1
        return mask.to(device=device, dtype=torch.bool)


class Dropout(nn.Module):
    """Keeps each element with probability ``KEEP`` and scales it by
    1 / ``KEEP`` in train mode (flax's and torch's convention); the
    identity in eval mode. The mask comes from ``mask_source``."""

    def __init__(self):
        super().__init__()
        self.mask_source: Optional[MaskSource] = None

    def forward(self, x):
        if not self.training:
            return x
        if self.mask_source is None:
            raise RuntimeError(
                "Dropout in train mode has no mask source; the train state installs "
                "one (train.state.create_train_state), tests install "
                "models.fcn_vgg.GivenMasks with set_mask_source")
        keep = self.mask_source(tuple(x.shape), x.device)
        return torch.where(keep, x / KEEP, 0.0)


def dropout_layers(module: nn.Module) -> List[Dropout]:
    return [m for m in module.modules() if isinstance(m, Dropout)]


def set_mask_source(module: nn.Module, source: Optional[MaskSource]) -> None:
    """Set ``source`` on every ``Dropout`` of ``module``."""
    for m in dropout_layers(module):
        m.mask_source = source


class VGG16FeatureGenerator(nn.Module):
    """[B, input_ch, H, W] -> (pool3 [B,256,H/8,W/8], pool4 [B,512,H/16,W/16],
    drop7 [B,4096,H/32,W/32]), each extent rounded up."""

    out_dim = 4096

    def __init__(self, input_ch: int = 3):
        super().__init__()
        cin = input_ch
        for si, (n_convs, ch) in enumerate(VGG16_STAGES):
            for ci in range(n_convs):
                self.add_module(f"conv{si + 1}_{ci + 1}", Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.conv6 = Conv2d(cin, self.out_dim, 7, padding=3)
        self.drop6 = Dropout()
        self.conv7 = Conv2d(self.out_dim, self.out_dim, 1)
        self.drop7 = Dropout()

    def forward(self, x):
        feats = []
        for si, (n_convs, _) in enumerate(VGG16_STAGES):
            for ci in range(n_convs):
                x = torch.relu(getattr(self, f"conv{si + 1}_{ci + 1}")(x))
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)
            feats.append(x)
        y = self.drop6(torch.relu(self.conv6(feats[4])))
        y = self.drop7(torch.relu(self.conv7(y)))
        return feats[2], feats[3], y


class FCN8sClassifier(RowSplit, nn.Module):
    """The FCN8s decoder (an F network): score conv7 / pool4 / pool3 (1x1
    convs with bias), fuse with 2x upsamples, then 8x to full resolution.
    As in the JAX head, the scores are cast to at least float32 and the
    fusion and both upsamples run in that dtype (outside any bf16
    autocast). Under a spatial layout in training the features, the fused
    maps and the output are row blocks."""

    def __init__(self, in_ch: int, n_class: int, upsample: str = "convt"):
        super().__init__()
        del in_ch  # the three inputs have fixed widths
        self.upsample = upsample
        self.score7 = nn.Conv2d(VGG16FeatureGenerator.out_dim, n_class, 1)
        self.score4 = nn.Conv2d(VGG16_STAGES[3][1], n_class, 1)
        self.score3 = nn.Conv2d(VGG16_STAGES[2][1], n_class, 1)

    def forward(self, feats):
        pool3, pool4, conv7 = feats
        scores = [self.score7(conv7), self.score4(pool4), self.score3(pool3)]
        dt = torch.promote_types(scores[0].dtype, torch.float32)
        s7, s4, s3 = (s.to(dt) for s in scores)
        dp = self.row_split()
        with torch.autocast(s7.device.type, enabled=False):
            x = self._fuse(self._fuse(s7, s4, dp), s3, dp)  # /16, then /8
            return upsample_logits(x, 8, self.upsample, dp)

    def _fuse(self, coarse, skip, dp: Optional[DataParallel]):
        up = upsample_logits(coarse, 2, self.upsample, dp)
        if dp is not None:
            # a row block's crop by the whole map's extent would misplace
            # rows; at the heights a layout allows there is nothing to crop
            assert up.shape[2:] == skip.shape[2:], (tuple(up.shape), tuple(skip.shape))
            return up + skip
        return up[:, :, :skip.shape[2], :skip.shape[3]] + skip
