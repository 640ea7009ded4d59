"""CUDA kernels of the port against their plain PyTorch versions, on the card
(the heads' upsample also against cuDNN's transposed convolution, which the
port ran before), torch's native SyncBatchNorm ops against the port's plain
twin, and the program's spans and counters (``utils/profiler.py``) on the
card's clock.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a card every test skips (a CUDA kernel has no CPU mode).
Tolerances: float32 output within 1e-6 of the plain version (same IEEE
division formula); bf16 output within half a bf16 ulp of the float32 plain
result (round to nearest). The upsample: bf16 within 1 bf16 ulp of cuDNN's
(both sum in float32 and round once; see ``_within_ulp``), float32 within
1e-6 and float64 within 1e-12 of the largest value of the plain version.
"""

import numpy as np
import pytest
import torch

from mcseg_tpu_torch.ops.normalize import fused_normalize_stack, normalize_stack_reference

E_CH = {3: 0, 6: 3, 4: 1, 1: 1, 7: 4}
# longer than one block's staging (48 KB of shared memory) in every instance:
# the longest segment, input_ch 1 with bf16 out, holds 8176 pixels
LONG_W = 8237


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(rng, device, input_ch, rgb_float, b, h, w):
    rgb = torch.from_numpy(rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)).to(device)
    if rgb_float:
        rgb = rgb.float() / 255.0
    e = E_CH[input_ch]
    extra = torch.from_numpy(rng.rand(b, h, w, e).astype(np.float32)).to(device) if e else None
    return rgb, extra


def _at_offset(t, offset_elems):
    """A contiguous copy of ``t`` that starts ``offset_elems`` elements into
    a larger buffer, so its rows are not 16-byte aligned."""
    buf = torch.empty(t.numel() + offset_elems, dtype=t.dtype, device=t.device)
    view = buf[offset_elems:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _assert_kernel_matches(rgb, extra, flip, input_ch):
    want = normalize_stack_reference(rgb, extra, flip, input_ch, torch.float32)
    b, h, w, _ = rgb.shape
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fused_normalize_stack.launches
        got = fused_normalize_stack(rgb, extra, flip, input_ch, out_dtype)
        torch.cuda.synchronize()
        assert fused_normalize_stack.launches == before + 1
        assert got.dtype == out_dtype and tuple(got.shape) == (b, h, w, input_ch)
        err = (got.float() - want).abs()
        if out_dtype == torch.float32:
            assert float(err.max()) <= 1e-6
        else:
            assert bool((err <= want.abs() * 2.0 ** -8).all())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [640, 300, 37, 16, 1])
@pytest.mark.parametrize("input_ch", [3, 6, 4, 1, 7])
@pytest.mark.parametrize("rgb_float", [False, True])
def test_normalize_stack_kernel_matches_plain_version(cuda_device, input_ch, rgb_float, w):
    # odd H; ragged and unaligned rows at W 300, 37 and 1
    rng = np.random.RandomState(4)
    for b, flips in ((3, [0, 1, 1]), (1, [1])):
        rgb, extra = _inputs(rng, cuda_device, input_ch, rgb_float, b, 37, w)
        flip = torch.tensor(flips, dtype=torch.int32, device=cuda_device)
        _assert_kernel_matches(rgb, extra, flip, input_ch)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [640, 37])
@pytest.mark.parametrize("input_ch", [3, 6, 4, 1, 7])
@pytest.mark.parametrize("rgb_float", [False, True])
def test_normalize_stack_kernel_unaligned_inputs(cuda_device, input_ch, rgb_float, w):
    # uint8 RGB 1 byte into its buffer, float RGB and the extra planes 4 bytes
    rng = np.random.RandomState(5)
    rgb, extra = _inputs(rng, cuda_device, input_ch, rgb_float, 2, 5, w)
    rgb = _at_offset(rgb, 1)
    if extra is not None:
        extra = _at_offset(extra, 1)
    flip = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    _assert_kernel_matches(rgb, extra, flip, input_ch)


@pytest.mark.cuda
@pytest.mark.parametrize("input_ch", [3, 6, 4, 1, 7])
@pytest.mark.parametrize("rgb_float", [False, True])
def test_normalize_stack_kernel_rows_longer_than_staging(cuda_device, input_ch, rgb_float):
    rng = np.random.RandomState(6)
    rgb, extra = _inputs(rng, cuda_device, input_ch, rgb_float, 2, 3, LONG_W)
    flip = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    _assert_kernel_matches(rgb, extra, flip, input_ch)


@pytest.mark.cuda
@pytest.mark.parametrize("input_ch", [3, 6, 4, 1, 7])
@pytest.mark.parametrize("rgb_float", [False, True])
def test_normalize_stack_kernel_many_rows_per_block(cuda_device, input_ch, rgb_float):
    # short rows: a block stages several whole rows, flipped row by row; the
    # spans are unaligned at W = 37 and the last block of a sample is short
    rng = np.random.RandomState(7)
    rgb, extra = _inputs(rng, cuda_device, input_ch, rgb_float, 2, 2500, 37)
    flip = torch.tensor([1, 0], dtype=torch.int32, device=cuda_device)
    _assert_kernel_matches(rgb, extra, flip, input_ch)


@pytest.mark.cuda
def test_normalize_stack_kernel_rejects_non_contiguous(cuda_device):
    rgb = torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda_device)
    extra = torch.zeros((2, 16, 8, 3), device=cuda_device).transpose(1, 2)
    flip = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fused_normalize_stack(rgb, extra, flip, 6)


# the heads' upsample at the benchmark cells' shapes: [B, C, h, w] scores of
# DRN-D-38 RGB+HHA batch 24 and DRN-D-105 batch 16 at 1024x512 in training,
# and the served batch 8, 8x to full size
UPSAMPLE_CELLS = {"train_b24": (24, 40, 60, 80), "train_1024x512_b16": (16, 19, 64, 128),
                  "serve_b8": (8, 40, 60, 80)}
# the other callers: (shape, factor, pads, layout): an aux head (C = 1), FCN8s's
# 2x, a row block's halo padding (f/2 + f, f/2), NCHW input, rows whose bytes
# are no multiple of 16 (written element by element), an odd factor
UPSAMPLE_OTHERS = {
    "aux_head_c1": ((4, 1, 60, 80), 8, (4, 4), "channels_last"),
    "fcn8s_2x": ((2, 19, 32, 64), 2, (1, 1), "channels_last"),
    "fcn8s_8x_nchw": ((2, 19, 16, 32), 8, (4, 4), "nchw"),
    "halo_rows": ((2, 40, 62, 80), 8, (12, 4), "channels_last"),
    "nchw": ((3, 40, 20, 24), 8, (4, 4), "nchw"),
    "unaligned_rows": ((2, 19, 7, 9), 2, (1, 1), "channels_last"),
    "odd_factor": ((2, 5, 6, 7), 3, (1, 1), "channels_last"),
}


def _scores(shape, dtype, layout, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else x


def _cudnn_convt(x, factor, pads):
    """cuDNN's depthwise transposed conv, the port's route before the kernel:
    its output and autograd's gradient of it."""
    import torch.nn.functional as F

    from mcseg_tpu_torch.ops.upsample import bilinear_kernel

    k = torch.from_numpy(bilinear_kernel(2 * factor, np.float64)).to(x.device, x.dtype)
    w = k.expand(x.shape[1], 1, 2 * factor, 2 * factor).contiguous()
    return lambda t: F.conv_transpose2d(t, w, stride=factor, padding=pads, groups=x.shape[1])


def _within_ulp(got, want):
    """Every bf16 value within 1 bf16 ulp of ``want``'s. Values below 2^-16
    of the largest are held to 2^-16 of the largest: there float32 sums
    taken in another order may move a value by more than its own ulp."""
    got, want = got.float(), want.float()
    mag = want.abs()
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
    bound = torch.maximum(ulp, mag.max() * 2.0 ** -16)
    err = (got - want).abs()
    assert bool((err <= bound).all()), (float(err.max()), float((err / bound).max()))


def _same_format(a, b):
    fmt = torch.channels_last
    assert (a.is_contiguous(), a.is_contiguous(memory_format=fmt)) == (
        b.is_contiguous(), b.is_contiguous(memory_format=fmt))


def _assert_upsample_matches_cudnn(x, factor, pads):
    """Forward and backward through ``mcseg::upsample_convt`` against cuDNN,
    one launch each, in the memory format cuDNN gives."""
    from mcseg_tpu_torch.ops.upsample import _upsample_convt_op, upsample_bilinear_convt

    convt = _cudnn_convt(x, factor, pads)
    ref = x.detach().clone().requires_grad_(True)
    want = convt(ref)
    dy = torch.randn_like(want)
    want.backward(dy)
    x = x.detach().clone().requires_grad_(True)
    fwd, bwd = upsample_bilinear_convt.launches, upsample_bilinear_convt.backward_launches
    got = _upsample_convt_op(x, factor, *pads)
    got.backward(dy)
    torch.cuda.synchronize()
    assert upsample_bilinear_convt.launches == fwd + 1
    assert upsample_bilinear_convt.backward_launches == bwd + 1
    assert got.dtype == x.dtype and got.shape == want.shape
    _same_format(got, want)
    _same_format(x.grad, ref.grad)
    _within_ulp(got, want)
    _within_ulp(x.grad, ref.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(UPSAMPLE_CELLS))
def test_upsample_kernels_match_cudnn_at_the_cells_shapes(cuda_device, cell):
    x = _scores(UPSAMPLE_CELLS[cell], torch.bfloat16, "channels_last", cuda_device)
    _assert_upsample_matches_cudnn(x, 8, (4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in UPSAMPLE_OTHERS if c != "odd_factor"])
def test_upsample_kernels_match_cudnn_for_the_other_callers(cuda_device, case):
    # an odd factor's 2-D taps (products of thirds) round in bf16 and the
    # kernel's separable taps do not: it is held in float32 and float64 below
    shape, factor, pads, layout = UPSAMPLE_OTHERS[case]
    _assert_upsample_matches_cudnn(_scores(shape, torch.bfloat16, layout, cuda_device),
                                   factor, pads)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(UPSAMPLE_OTHERS))
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)],
                         ids=["float64", "float32"])
def test_upsample_kernels_match_the_plain_version(cuda_device, case, dtype, tol):
    """Against the op's CPU implementation on the same values, forward and
    backward; fp16 within 1 fp16 ulp of the float64 plain values."""
    from mcseg_tpu_torch.ops.upsample import _upsample_convt_backward_op, _upsample_convt_op

    shape, factor, pads, layout = UPSAMPLE_OTHERS[case]
    x = _scores(shape, dtype, layout, cuda_device, seed=1)
    y = _upsample_convt_op(x, factor, *pads)
    dy = torch.randn_like(y)
    dx = _upsample_convt_backward_op(dy, factor, *pads)
    for got, want in ((y, _upsample_convt_op(x.cpu(), factor, *pads)),
                      (dx, _upsample_convt_backward_op(dy.cpu(), factor, *pads))):
        _same_format(got, want)
        assert float((got.cpu() - want).abs().max()) <= tol * float(want.abs().max())
    h = _upsample_convt_op(x.to(torch.float16), factor, *pads).double().cpu()
    want = _upsample_convt_op(x.to(torch.float16).double().cpu(), factor, *pads)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -14))) - 10)
    assert bool(((h - want).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_upsample_kernels_pass_gradcheck(cuda_device, layout):
    from mcseg_tpu_torch.ops.upsample import upsample_bilinear_convt

    x = _scores((2, 3, 4, 5), torch.float64, layout, cuda_device).requires_grad_(True)
    fn = lambda t: upsample_bilinear_convt(t, 8)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


@pytest.mark.cuda
def test_upsample_kernel_takes_strided_inputs_and_refuses_the_rest(cuda_device):
    from mcseg_tpu_torch.ops.upsample import _upsample_convt_backward_op, _upsample_convt_op

    x = _scores((2, 6, 10, 12), torch.bfloat16, "nchw", cuda_device)[:, ::2, 1:, ::3]
    assert not x.is_contiguous()  # copied to the format a convolution gives
    _within_ulp(_upsample_convt_op(x, 8, 4, 4), _cudnn_convt(x, 8, (4, 4))(x))
    with pytest.raises(TypeError):
        _upsample_convt_op(x.to(torch.int32), 8, 4, 4)
    wide = _scores((1, 600, 2, 2), torch.float32, "channels_last", cuda_device)
    with pytest.raises(ValueError, match="backward kernel does not take"):
        _upsample_convt_backward_op(_upsample_convt_op(wide, 8, 4, 4), 8, 4, 4)
    with pytest.raises(ValueError, match="forward kernel does not take"):
        _upsample_convt_op(wide, 33, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("num_workers", [0, 2])
def test_device_prefetch_on_the_card_yields_the_host_batches(cuda_device, num_workers):
    """Each prefetched pair equals the host pair in wire format. The consumer
    reads every tensor behind a sleep on its own stream and drops it at
    once, so a buffer handed out again under a running copy (no event wait
    or no record_stream) would change the sums."""
    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import (
        SyntheticDataset, SyntheticShiftedDataset, ZipDataset)
    from mcseg_tpu_torch.data.pipeline import batch_iterator, device_prefetch, wire_items

    cfg = DataConfig(train_img_shape=(320, 240), max_samples=16)
    z = ZipDataset(SyntheticDataset(cfg), SyntheticShiftedDataset(cfg))
    want = [wire_items(item) for item in batch_iterator(z, 4, seed=3, epochs=3)]
    sums = []
    stream = device_prefetch(batch_iterator(z, 4, seed=3, epochs=3, num_workers=num_workers),
                             cuda_device, depth=2)
    for pair in stream:
        torch.cuda._sleep(2_000_000)
        sums.append([{k: t.double().sum() for k, t in b.items()} for b in pair])
        del pair
    torch.cuda.synchronize()
    assert len(sums) == len(want) == 12
    for got, host in zip(sums, want):
        for g, h in zip(got, host):
            assert g.keys() == h.keys() and "label" in host[0] and "label" not in host[1]
            for k in h:
                assert float(g[k]) == float(h[k].astype(np.float64).sum()), k


@pytest.mark.cuda
@pytest.mark.parametrize("input_ch,rgb_float", [(6, False), (6, True), (3, False), (7, True)])
def test_custom_op_launches_the_kernel_and_matches_plain(cuda_device, input_ch, rgb_float):
    """``mcseg::normalize_stack`` called directly, as an exported graph
    calls it: the CUDA implementation launches the kernel once."""
    rng = np.random.RandomState(7)
    rgb, extra = _inputs(rng, cuda_device, input_ch, rgb_float, 4, 48, 64)
    flip = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device=cuda_device)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = fused_normalize_stack.launches
        got = torch.ops.mcseg.normalize_stack(rgb, extra, flip, input_ch, out_dtype)
        torch.cuda.synchronize()
        assert fused_normalize_stack.launches == before + 1
        want = normalize_stack_reference(rgb, extra, flip, input_ch, torch.float32)
        err = (got.float() - want).abs()
        if out_dtype == torch.float32:
            assert float(err.max()) <= 1e-6
        else:
            assert bool((err <= want.abs() * 2.0 ** -8).all())


@pytest.mark.cuda
def test_exported_serve_module_launches_the_kernel_per_call(cuda_device, tmp_path):
    """A small serving artifact exported on the card holds the op as a graph
    node, launches the kernel once per call after a save/load round trip,
    and gives the in-process class map."""
    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig
    from mcseg_tpu_torch.eval.serving import export_serving, load_serving, make_serve_fn
    from mcseg_tpu_torch.models.factory import init_models

    cfg = ExperimentConfig(
        model=ModelConfig(net="drn_d_14", input_ch=6, n_class=8, dtype="float32"),
        data=DataConfig(src_dataset="synthetic", tgt_dataset="synthetic",
                        test_img_shape=(64, 48), input_ch=6))
    params = init_models(cfg.model, torch.Generator().manual_seed(0))
    path = str(tmp_path / "m.pt2")
    export_serving(cfg, params, path, batch=2, device="cuda")
    program = torch.export.load(path)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and n.target == torch.ops.mcseg.normalize_stack.default]
    assert len(nodes) == 1
    rng = np.random.RandomState(8)
    request = {"image": rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8),
               "depth": (rng.rand(2, 48, 64) * 4 + 0.5).astype(np.float32)}
    call = load_serving(path)
    for i in range(3):
        before = fused_normalize_stack.launches
        pred = call(request)
        torch.cuda.synchronize()
        assert fused_normalize_stack.launches == before + 1, i
    live = make_serve_fn(cfg, params, device="cuda")(request)
    assert float((pred == live).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_jax_checkpoint_from_the_card_reads_back_bit_equal(cuda_device, tmp_path, opt):
    """A train state on the card after one MCD iteration, written as a JAX
    ``.msgpack`` by ``save_jax_checkpoint`` and read back onto the card by
    ``load_checkpoint`` (no ``.pt`` there): weights, BN statistics, the
    optimizer state and the step are bit-equal; a bfloat16 CUDA tensor
    survives the codec."""
    from mcseg_tpu_torch.core.config import ExperimentConfig, ModelConfig, TrainConfig
    from mcseg_tpu_torch.train.mcd import make_mcd_step
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils import msgpack_compat
    from mcseg_tpu_torch.utils.checkpoint import load_checkpoint, save_jax_checkpoint

    cfg = ExperimentConfig(model=ModelConfig(net="drn_d_14", input_ch=6, n_class=5,
                                             dtype="float32"),
                           train=TrainConfig(opt=opt, lr=0.01, num_k=2, seed=5))
    state = create_train_state(cfg.model, cfg.train, cfg.train.seed, "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = torch.randn(2, 6, 48, 64, device="cuda", generator=g)
    xt = torch.randn(2, 6, 48, 64, device="cuda", generator=g)
    ys = torch.randint(0, 5, (2, 48, 64), device="cuda", generator=g)
    make_mcd_step(cfg.train)(state, xs, ys, xt)
    prefix = str(tmp_path / "last")
    save_jax_checkpoint(prefix, state, cfg)
    back, _ = load_checkpoint(prefix, device="cuda")
    assert back.step == state.step == 1
    for name, m in state.modules().items():
        got = back.modules()[name].state_dict()
        for k, v in m.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert got[k].is_cuda and torch.equal(got[k], v), (name, k)
    for mine, theirs in ((back.opt_g, state.opt_g), (back.opt_f, state.opt_f)):
        a, b = mine.state_dict()["state"], theirs.state_dict()["state"]
        assert a.keys() == b.keys() and len(a) > 0
        for i in b:
            for k, v in b[i].items():
                assert torch.equal(a[i][k].cpu(), v.cpu()), (i, k)
    bf = torch.randn(3, 5, device="cuda").to(torch.bfloat16)
    got = msgpack_compat.restore(msgpack_compat.serialize({"x": bf}))["x"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf.cpu())


@pytest.fixture
def one_rank_group(cuda_device):
    """A one-rank gloo group on the card, left at the end."""
    import socket

    from mcseg_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dp = multihost.initialize(f"127.0.0.1:{port}", 1, 0, "cuda:0", backend="gloo")
    try:
        yield dp
    finally:
        multihost.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12), (torch.float32, 1e-4),
                                         (torch.bfloat16, 2.0 ** -7)])
def test_native_sync_batch_norm_matches_its_twin(one_rank_group, dtype, bound):
    """torch's native SyncBatchNorm ops against the plain twin: output,
    running statistics and the three gradients, relative to each one's
    largest magnitude (float32: sums in another order; bf16: the output
    may round to the neighbouring bf16 value)."""
    from mcseg_tpu_torch.parallel import sync_bn

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(4, 16, 24, 40, generator=gen, device="cuda") * 2 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    up = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32
    w = (torch.rand(16, generator=gen, device="cuda") + 0.5).to(pdt)
    b = (torch.randn(16, generator=gen, device="cuda") * 0.1).to(pdt)

    def run(fn):
        xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
        rm, rv = torch.zeros(16, device="cuda", dtype=pdt), torch.ones(16, device="cuda", dtype=pdt)
        y = fn(xs, ws, bs, rm, rv, 0.1, 1e-5, one_rank_group)
        y.backward(up)
        return [y, rm, rv, xs.grad, ws.grad, bs.grad]

    calls = sync_bn.sync_batch_norm_native.calls
    got = run(sync_bn.sync_batch_norm_native)
    want = run(sync_bn.sync_batch_norm_reference)
    assert sync_bn.sync_batch_norm_native.calls == calls + 1
    assert got[0].dtype == dtype
    for g, v in zip(got, want):
        err = float((g.double() - v.double()).abs().max() / v.double().abs().max())
        assert err <= bound, err


@pytest.mark.cuda
def test_batch_norm_under_a_one_rank_group_is_plain_batch_norm(one_rank_group):
    """``models.drn.BatchNorm2d`` with the group's context (native ops)
    against cuDNN's BatchNorm without one, float64: the same output and
    the same flax-style running statistics."""
    from mcseg_tpu_torch.models.drn import BatchNorm2d, set_data_parallel

    x = torch.randn(4, 8, 12, 10, device="cuda", dtype=torch.float64) * 3 + 1
    plain, synced = (BatchNorm2d(8).to("cuda", torch.float64) for _ in range(2))
    set_data_parallel(synced, one_rank_group)
    for _ in range(2):
        torch.testing.assert_close(synced(x), plain(x), rtol=1e-12, atol=1e-12)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        torch.testing.assert_close(getattr(synced, name), getattr(plain, name),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(48, 64), (480, 640)])
def test_hha_of_an_image_is_bit_equal_at_batch_1_4_and_8(cuda_device, hw):
    """One image's HHA does not depend on the batch it is encoded in (ranks
    that encode part of a batch get what one process gets)."""
    from mcseg_tpu_torch.core.config import DataConfig
    from mcseg_tpu_torch.data.datasets import get_dataset, stack_samples
    from mcseg_tpu_torch.ops.hha import depth_to_hha_batch

    h, w = hw
    cfg = DataConfig(train_img_shape=(w, h), test_img_shape=(w, h))
    depth = torch.as_tensor(stack_samples(get_dataset("synthetic_shifted", cfg, "train"),
                                          range(8))["depth"]).to(cuda_device)
    depth[0, :3, :5] = 0.0  # missing pixels
    full = depth_to_hha_batch(depth)
    assert torch.equal(depth_to_hha_batch(depth[:4]), full[:4])
    assert torch.equal(depth_to_hha_batch(depth[4:]), full[4:])
    for i in range(8):
        assert torch.equal(depth_to_hha_batch(depth[i:i + 1])[0], full[i]), i


@pytest.mark.cuda
def test_halo_exchange_over_gloo_on_the_card_equals_the_unsplit_ops(cuda_device):
    """2 gloo ranks sharing the card (NCCL refuses two ranks on one device),
    one row block each, float64: the halo conv (the 7x7 stem, a stride-2
    3x3 and dilation 4's halo of a whole block) and the 8x upsample in both
    modes against the unsplit ops on the card, forward and backward, within
    1e-12."""
    import torch.nn.functional as F

    from _torch_parallel_worker import spawn
    from mcseg_tpu_torch.ops.upsample import upsample_logits

    rng = np.random.RandomState(0)
    cases = [(7, 1, 1), (3, 2, 1), (3, 1, 4)]
    convs = [(rng.randn(2, 3, 8, 5), rng.randn(2, 4, 8 // s, -(-5 // s)),
              rng.randn(4, 3, k, k), s, d) for k, s, d in cases]
    up = (rng.randn(2, 3, 2, 5), rng.randn(2, 3, 16, 40), 8)
    ranks = spawn([("halo", dict(space=2, convs=convs, upsample=up))], world=2,
                  device="cuda:0")

    def unsplit(fn, x, probe, w=None):
        x = torch.from_numpy(x).to(cuda_device).requires_grad_(True)
        w = None if w is None else torch.from_numpy(w).to(cuda_device).requires_grad_(True)
        y = fn(x, w)
        (y * torch.from_numpy(probe).to(cuda_device)).sum().backward()
        return y.detach().cpu(), x.grad.cpu(), None if w is None else w.grad.cpu()

    def close(got, want):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-12

    def rows(t, r):
        n = t.shape[2] // 2
        return t[:, :, r * n:(r + 1) * n]

    for i, (x, probe, w, s, d) in enumerate(convs):
        y, dx, dw = unsplit(lambda t, wt: F.conv2d(t, wt, stride=s, padding=d * (w.shape[-1] // 2),
                                                   dilation=d), x, probe, w)
        got = [r[0]["convs"][i] for r in ranks]
        for r, g in enumerate(got):
            close(g["y"], rows(y, r))
            close(g["dx"], rows(dx, r))
        close(sum(g["grads"]["weight"] for g in got), dw)
    for mode in ("convt", "resize"):
        y, dx, _ = unsplit(lambda t, _: upsample_logits(t, 8, mode), up[0], up[1])
        for r, res in enumerate(ranks):
            close(res[0]["upsample"][mode]["y"], rows(y, r))
            close(res[0]["upsample"][mode]["dx"], rows(dx, r))


def _span_cfg(batch):
    from mcseg_tpu_torch.core.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig

    return ExperimentConfig(
        model=ModelConfig(net="drn_d_22", input_ch=6, n_class=40, dtype="bfloat16"),
        data=DataConfig(src_dataset="suncg", tgt_dataset="nyu", batch_size=batch,
                        train_img_shape=(640, 480), test_img_shape=(640, 480), input_ch=6,
                        hha_on_device=True, random_crop=True, crop_scale_min=0.7,
                        random_flip=True),
        train=TrainConfig(lr=1e-3, num_k=1, max_steps=100))


def _span_raw(seed, b):
    r = np.random.RandomState(seed)
    return {"image": torch.from_numpy(r.randint(0, 255, (b, 480, 640, 3)).astype(np.uint8)),
            "label": torch.from_numpy(r.randint(0, 41, (b, 480, 640)).astype(np.uint8)),
            "depth": torch.from_numpy(r.rand(b, 480, 640).astype(np.float32) * 3 + 0.5)}


@pytest.mark.cuda
def test_upsample_spans_time_the_upsample_kernels_on_the_card(cuda_device):
    """One traced MCD iteration of drn_d_22 RGB+HHA, batch 16 at 640x480,
    bf16, ``num_k`` 1: every span's device ms is positive (a ``host_wait``
    span's at least 0), the iteration makes 13 blocking host-to-card
    copies, each in a ``host_wait`` span beside HHA's 6 eighs, the
    upsample's 8 forwards and 8 backwards launch the kernels (the counter
    ``upsample_kernel`` counts 16) and nothing of cuDNN's transposed
    convolution runs, and the ``upsample`` spans' device ms, forward and
    backward, lie within 5% of the profiler's time of the two kernels, plus
    0.02 ms a span: a kernel takes ~0.1 ms here, and a span also holds its
    two timing events and, where the card is ahead of the host, the idle
    while the host enters the op."""
    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.train.loops import make_adapt_iteration
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils import profiler

    cfg = _span_cfg(16)
    state = create_train_state(cfg.model, cfg.train, 0, cuda_device)
    iterate = make_adapt_iteration(cfg)
    src, tgt = ({k: v.to(cuda_device) for k, v in _span_raw(s, 16).items()}
                for s in (0, 1))
    iterate(state, src, tgt)  # warm-up
    torch.cuda.synchronize()
    profiler.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        iterate(state, src, tgt)
        torch.cuda.synchronize()
    records = profiler.span_records()
    profiler.reset_spans()
    spans = [r for r in records if r["kind"] == "span" and r["name"] != "host_wait"]
    waits = [r for r in records if r["kind"] == "span" and r["name"] == "host_wait"]
    assert len(spans) == 1 + 1 + 4 + 2 + 3 + 16 and all(r["device_ms"] > 0 for r in spans)
    assert sum(r["count"] for r in records if r["name"] == "h2d_blocking") == 13
    assert len(waits) == 13 + 6 and all(r["device_ms"] >= 0 for r in waits)
    assert sum(r["count"] for r in records if r["name"] == "upsample_kernel") == 16
    ups = [r for r in spans if r["name"] == "upsample"]
    span_ms = sum(r["device_ms"] for r in ups)
    events = prof.events()
    names = {e.name for e in events}
    assert "aten::conv_transpose2d" not in names  # nor, then, its ConvolutionBackward0
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and ("upsample_forward_kernel" in e.name or "upsample_backward_kernel" in e.name)]
    assert len(kernels) == 16, sorted({e.name for e in kernels})
    kernel_ms = sum(e.time_range.elapsed_us() for e in kernels) * 1e-3
    print("upsample spans", span_ms, "ms, kernels", kernel_ms, "ms")
    assert abs(span_ms - kernel_ms) <= 0.05 * kernel_ms + 0.02 * len(ups), (span_ms, kernel_ms)


@pytest.mark.cuda
@pytest.mark.parametrize("host", [True, False], ids=["host_traced", "device_only"])
def test_served_request_spans_and_copies_on_the_card(cuda_device, host):
    """A request of the serving entry records its spans with positive device
    ms and 3 blocking copies (the image and depth planes, HHA's gravity),
    each in a ``host_wait`` span beside HHA's 3 eighs,
    under a profiler that traces the host, and under one that traces the
    card's activity alone."""
    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils import profiler

    cfg = _span_cfg(2)
    serve = make_serve_fn(cfg, create_train_state(cfg.model, cfg.train, 0, "cpu").params(),
                          cuda_device)
    request = {k: v.numpy() for k, v in _span_raw(2, 2).items() if k != "label"}
    serve(request)
    torch.cuda.synchronize()
    profiler.reset_spans()
    acts = [ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]
    with profile(activities=acts):
        serve(request).cpu()
    records = profiler.span_records()
    profiler.reset_spans()
    spans = [r for r in records if r["kind"] == "span" and r["name"] != "host_wait"]
    waits = [r for r in records if r["kind"] == "span" and r["name"] == "host_wait"]
    assert [r["name"] for r in spans] == ["serve.request", "serve.to_device", "hha", "upsample"]
    assert all(r["device_ms"] > 0 and r["root"] == spans[0]["id"] for r in spans)
    assert sum(r["count"] for r in records if r["name"] == "h2d_blocking") == 3
    assert len(waits) == 3 + 3 and all(r["root"] == spans[0]["id"] for r in waits)
    assert sum(r["count"] for r in records if r["name"] == "upsample_kernel") == 1


@pytest.mark.cuda
def test_every_wait_of_a_request_lies_in_a_host_wait_span(cuda_device):
    """Each call of a served request at which the host waits for the card
    (``torch.cuda.set_sync_debug_mode`` warns at every one) lies inside a
    ``host_wait`` span, so that the serving entry's host ms less its
    ``host_wait`` spans' (the benchmark's ``enqueue_ms.serve``) holds no
    wait for the card."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from mcseg_tpu_torch.eval.serving import make_serve_fn
    from mcseg_tpu_torch.train.state import create_train_state
    from mcseg_tpu_torch.utils import profiler

    cfg = _span_cfg(2)
    serve = make_serve_fn(cfg, create_train_state(cfg.model, cfg.train, 0, "cpu").params(),
                          cuda_device)
    request = {k: v.numpy() for k, v in _span_raw(2, 2).items() if k != "label"}
    serve(request)
    torch.cuda.synchronize()
    profiler.reset_spans()
    syncs = []  # (the spans open at a synchronizing call, its site)

    def note(message, category, filename, lineno, *args, **kwargs):
        if "synchroniz" in str(message):
            syncs.append(([sid for sid, _ in profiler._stack()], f"{filename}:{lineno}"))

    with profile(activities=[ProfilerActivity.CUDA]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")  # warns once itself, before the request
            warnings.showwarning = note
            try:
                serve(request)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    records = profiler.span_records()
    profiler.reset_spans()
    names = {r["id"]: r["name"] for r in records if r["kind"] == "span"}
    opened = [([names.get(sid) for sid in stack], site) for stack, site in syncs]
    print("syncs in a request:", len(opened), opened)
    assert opened and all("host_wait" in spans for spans, _ in opened), opened
