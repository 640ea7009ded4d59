"""Operations and bytes of a cell, counted from the configuration's shapes.

FLOPs are two per multiply-add of the work the algorithm needs:

* every convolution of G (DRN arch D, ``model`` of a configuration file)
  and of the heads' 1x1 score convs, forward; backward only where the MCD
  iteration takes gradients: step A through G, F1 and F2 (weights and
  inputs, but not the input image's), step B through F1 and F2 (the score
  convs' weights; G runs without gradients), step C through G (weights
  and inputs, and the heads' inputs on the way; not the heads' weights);
* the heads' 8x upsample as bilinear interpolation: 2 x 2 multiply-adds
  per output element, forward and for the gradient of its input, however
  the program computes it;
* nothing for elementwise work (BatchNorm, ReLU, softmax, the losses, the
  optimizer, the preprocess), and nothing recomputed.

A later program that computes a layer another way leaves the count as it
is. ``tests/test_bench_counts.py`` holds it equal to
``torch.utils.flop_counter.FlopCounterMode`` over the reference's MCD
iteration, which takes exactly these gradients.

Bytes: the normalize/stack step's least traffic, each input byte read once
and each output byte written once (``normalize_stack_bytes``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

UP = 8  # the heads' upsample factor (output stride of DRN arch D)


def _out(size: int, stride: int) -> int:
    return (size - 1) // stride + 1  # "same" padding


def trunk_convs(model: Dict, hw: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Multiply-adds per image of each convolution of G, in order, as
    (MACs, 1 if it reads the input image else 0)."""
    ch, layers = model["channels"], model["layers"]
    expansion = 4 if model["block"] == "bottleneck" else 1
    h, w = hw
    convs: List[Tuple[int, int]] = []

    def conv(cin, cout, k, stride=1, first=0):
        nonlocal h, w
        h, w = _out(h, stride), _out(w, stride)
        convs.append((h * w * cout * cin * k * k, first))

    conv(model["input_ch"], ch[0], 7, first=1)
    cin = ch[0]
    for level, stride in ((0, 1), (1, 2)):  # conv stages 1 and 2
        for i in range(layers[level]):
            conv(cin, ch[level], 3, stride if i == 0 else 1)
            cin = ch[level]
    for level, stride in ((2, 2), (3, 2), (4, 1), (5, 1)):  # residual stages 3-6
        feat, out = ch[level], ch[level] * expansion
        for i in range(layers[level]):
            s = stride if i == 0 else 1
            h0, w0 = h, w
            if expansion == 1:
                conv(cin, feat, 3, s)
                conv(feat, feat, 3)
            else:
                conv(cin, feat, 1)
                conv(feat, feat, 3, s)
                conv(feat, out, 1)
            if s != 1 or cin != out:  # the projection reads the block's input
                h, w = h0, w0
                conv(cin, out, 1, s)
            cin = out
    for level in (6, 7):  # conv stages 7 and 8
        for _ in range(layers[level]):
            conv(cin, ch[level], 3)
            cin = ch[level]
    return convs


def _parts(model: Dict, batch: int, hw: Tuple[int, int]) -> Dict[str, int]:
    """Multiply-adds of the batch: G forward, G's input gradients, one
    score conv, one upsample."""
    convs = trunk_convs(model, hw)
    h, w = hw
    for _ in range(3):
        h, w = _out(h, 2), _out(w, 2)
    g = sum(m for m, _ in convs)
    return {"g": batch * g, "g_in": batch * sum(m for m, first in convs if not first),
            "score": batch * h * w * model["channels"][7] * model["n_class"],
            "up": batch * (UP * h) * (UP * w) * model["n_class"] * 4}


def train_flops(model: Dict, num_k: int, batch: int, hw: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one MCD iteration on ``batch`` source and ``batch`` target
    images: ``total`` and ``trunk`` (G's part)."""
    p = _parts(model, batch, hw)
    g, g_in, s, u = p["g"], p["g_in"], p["score"], p["up"]
    head_fwd = s + u
    step_a = (g + 2 * head_fwd) + (2 * (u + s + s) + g + g_in)
    step_b = (2 * g + 4 * head_fwd) + 4 * (u + s)
    step_c = (g + 2 * head_fwd) + (2 * (u + s) + g + g_in)
    trunk = (g + g + g_in) + 2 * g + num_k * (g + g + g_in)
    return {"total": 2.0 * (step_a + step_b + num_k * step_c), "trunk": 2.0 * trunk}


def serve_flops(model: Dict, batch: int, hw: Tuple[int, int]) -> float:
    """FLOPs of one served request: G and one head (the average of F1 and
    F2 is one head), forward."""
    p = _parts(model, batch, hw)
    return 2.0 * (p["g"] + p["score"] + p["up"])


def normalize_stack_bytes(batch: int, hw, input_ch: int, rgb_bytes: int,
                          extra_bytes: int = 4, out_bytes: int = 2) -> int:
    """Least bytes of one normalize/stack launch: RGB (``rgb_bytes`` a
    value: 4 for float32 crops, 1 for uint8 frames) and the extra planes
    (float32) read once, the int32 flip flags, the stacked output written
    once (``out_bytes``: 2 for bfloat16)."""
    px = batch * hw[0] * hw[1]
    return px * 3 * rgb_bytes + px * (input_ch - 3) * extra_bytes + batch * 4 + \
        px * input_ch * out_bytes
