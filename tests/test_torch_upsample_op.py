"""The heads' ``convt`` upsample as the custom ops ``mcseg::upsample_convt``
and ``mcseg::upsample_convt_backward`` (``mcseg_tpu_torch/ops/upsample.py``)
on the CPU, where they run the plain version.

``torch.library.opcheck`` holds each op's registration (schema, autograd,
the fake version against the real one, AOT dispatch); the forward equals
the depthwise ``F.conv_transpose2d`` with fill_up_weights bit for bit, its
gradient autograd's of that convolution (float64 within 1e-12, float32
within 1e-6 of the largest); the output keeps the memory format the
convolution gives; a CPU call launches no kernel and counts none; an
exported module holds the op as one node. The kernels themselves run on
the card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from mcseg_tpu_torch.ops import upsample as U
from mcseg_tpu_torch.utils import profiler

# (factor, (pad_h, pad_w)): the heads' 8x, FCN8s's 2x, a row block's halo
# padding (f/2 + f, f/2), and an odd factor
CASES = [(8, (4, 4)), (2, (1, 1)), (8, (12, 4)), (3, (1, 1))]
LAYOUTS = ["nchw", "channels_last"]


def _x(c=3, dtype=torch.float64, layout="nchw", h=5, w=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, c, h, w, generator=g, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _convt(x, factor, pads):
    k = torch.from_numpy(U.bilinear_kernel(2 * factor, np.float64)).to(x.dtype)
    w = k.expand(x.shape[1], 1, 2 * factor, 2 * factor).contiguous()
    return F.conv_transpose2d(x, w, stride=factor, padding=pads, groups=x.shape[1])


@pytest.mark.parametrize("factor,pads", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_ops_pass_opcheck(factor, pads, layout):
    x = _x(layout=layout).requires_grad_(True)
    y = U._upsample_convt_op(x, factor, *pads)
    for op, arg in ((U._upsample_convt_op, x), (U._upsample_convt_backward_op,
                                                 torch.randn_like(y).requires_grad_(True))):
        result = torch.library.opcheck(op, (arg, factor, *pads))
        assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("factor,pads", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_op_is_the_depthwise_transposed_conv(factor, pads, layout, c, dtype, tol):
    x = _x(c, dtype, layout).requires_grad_(True)
    ref = x.detach().clone().requires_grad_(True)
    y = U._upsample_convt_op(x, factor, *pads)
    want = _convt(ref, factor, pads)
    assert torch.equal(y, want)
    fmt = torch.channels_last
    assert (y.is_contiguous(), y.is_contiguous(memory_format=fmt)) == (
        want.is_contiguous(), want.is_contiguous(memory_format=fmt))
    g = torch.randn_like(y)
    y.backward(g)
    want.backward(g)
    assert x.grad.shape == x.shape
    assert float((x.grad - ref.grad).abs().max()) <= tol * float(ref.grad.abs().max())


def test_upsample_bilinear_convt_launches_nothing_on_the_cpu():
    x = _x(c=40, layout="channels_last", h=6, w=8).requires_grad_(True)
    before = (U.upsample_bilinear_convt.launches, U.upsample_bilinear_convt.backward_launches)
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        y = U.upsample_bilinear_convt(x, 8)
        y.sum().backward()
    records = profiler.span_records()
    profiler.reset_spans()
    assert y.shape == (2, 40, 48, 64) and y.is_contiguous(memory_format=torch.channels_last)
    assert (U.upsample_bilinear_convt.launches,
            U.upsample_bilinear_convt.backward_launches) == before
    assert not [r for r in records if r["name"] == "upsample_kernel"]


def test_gradients_pass_gradcheck_twice():
    x = _x(c=2, h=3, w=4).requires_grad_(True)

    def fn(t):
        return U.upsample_bilinear_convt(t, 2)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_autocast_casts_a_float_input_as_a_convolution_does():
    x = _x(dtype=torch.float32)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = U.upsample_bilinear_convt(x, 8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _convt(x.to(torch.bfloat16), 8, (4, 4)))


def test_export_holds_the_op_as_one_node():
    class Head(torch.nn.Module):
        def forward(self, x):
            return U.upsample_bilinear_convt(x, 8)

    x = _x(c=4, dtype=torch.float32, layout="channels_last")
    ep = torch.export.export(Head(), (x,))
    targets = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert targets == [torch.ops.mcseg.upsample_convt.default]
    assert torch.equal(ep.module()(x), U.upsample_bilinear_convt(x, 8))


def test_a_gradient_of_no_forward_output_raises():
    with pytest.raises(ValueError, match="no input"):
        U._upsample_convt_backward_op(torch.zeros(1, 2, 7, 16), 8, 4, 4)
