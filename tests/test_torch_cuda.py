"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed; ``tests/conftest.py`` imports JAX, hence on the card:

    python -m pytest --noconftest tests/test_torch_cuda.py

Without a card every test skips (a CUDA kernel has no CPU mode).
Tolerances: float32 output within 1e-6 of the plain version (same IEEE
division formula); bf16 output within half a bf16 ulp of the float32 plain
result (round to nearest).
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
