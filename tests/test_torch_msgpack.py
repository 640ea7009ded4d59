"""The port's flax-compatible msgpack codec (``utils/msgpack_compat.py``)
against flax's own: flax's bytes decode leaf for leaf (dtype, shape and
value; bfloat16 as a torch tensor, bit for bit), flax decodes the port's
bytes to the same tree, the two encoders give the same bytes, chunked
arrays travel both ways, and the committed JAX checkpoint fixture decodes
to what JAX's ``load_checkpoint`` restores."""

import gzip
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from mcseg_tpu_torch.utils import msgpack_compat
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")


def _tree():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 5).astype(np.float32),
        "bf16": jnp.asarray(rng.randn(4, 2), jnp.bfloat16),
        "i32": rng.randint(-2**31, 2**31 - 1, (7,), dtype=np.int64).astype(np.int32),
        "u32": np.asarray([0, 1, 2**32 - 1], np.uint32),
        "zero_d": np.asarray(3, np.int32),
        "f64_0d": np.asarray(-0.5, np.float64),
        "scalars": {"i": np.int32(-7), "f": np.float32(2.5), "u": np.uint32(9),
                    "bf": jnp.bfloat16(1.5)},
        "empty": {},
        "nested": {"e": {}, "k": np.zeros((0, 3), np.float32)},
        "py": {"n": None, "t": True, "f": False, "x": 1.25, "s": "name" * 10,
               "b": b"\x00\x01" * 200},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                 -32769, -2**40],
    }


def _assert_leaf(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_leaf(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, (jax.Array, np.ndarray, np.generic)):
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=path)
            return
        assert isinstance(got, (np.ndarray, np.generic)), (path, type(got))
        assert got.dtype == want.dtype and np.shape(got) == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    assert type(got) is type(want) and got == want, (path, got, want)


def test_port_decodes_flax_bytes_leaf_for_leaf():
    sd = serialization.to_state_dict(_tree())
    blob = serialization.to_bytes(_tree())
    _assert_leaf(msgpack_compat.restore(blob), jax.tree.map(lambda x: x, sd), "")
    # numpy scalars come back as numpy scalars, 0-d arrays as 0-d arrays
    got = msgpack_compat.restore(blob)
    assert isinstance(got["scalars"]["i"], np.int32)
    assert isinstance(got["zero_d"], np.ndarray) and got["zero_d"].shape == ()
    assert got["scalars"]["bf"].shape == () and got["scalars"]["bf"].dtype == torch.bfloat16


def _port_tree():
    """``_tree``'s state dict with bfloat16 leaves as torch tensors, the
    form the port holds them in."""
    def conv(x):
        if isinstance(x, (jax.Array, np.ndarray, np.generic)) \
                and np.asarray(x).dtype == jnp.bfloat16:
            bits = torch.from_numpy(np.asarray(x).view(np.int16).copy())
            return bits.view(torch.bfloat16)
        return x
    return jax.tree.map(conv, serialization.to_state_dict(_tree()))


def test_flax_decodes_port_bytes_and_the_bytes_match():
    port_tree = _port_tree()
    blob = msgpack_compat.serialize(port_tree)
    flax_blob = serialization.msgpack_serialize(serialization.to_state_dict(_tree()))
    assert blob == flax_blob
    back = serialization.msgpack_restore(blob)
    want = serialization.to_state_dict(_tree())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                jax.tree_util.tree_flatten_with_path(want)[0]):
        assert pa == pb
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, pa
        np.testing.assert_array_equal(a, b, err_msg=str(pa))


def test_chunked_arrays_both_ways(monkeypatch):
    """Arrays above the chunk size: flax's chunked map is read and written
    (the size lowered on both sides so a small array is chunked)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_compat, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(50, dtype=np.float32).reshape(5, 10), "b": np.ones(3, np.int32)}
    flax_blob = serialization.msgpack_serialize(dict(tree))
    port_blob = msgpack_compat.serialize(tree)
    assert port_blob == flax_blob
    for got in (msgpack_compat.restore(flax_blob), serialization.msgpack_restore(port_blob)):
        for k in tree:
            np.testing.assert_array_equal(got[k], tree[k])
            assert got[k].dtype == tree[k].dtype


def test_committed_fixture_decodes_as_jax_restores_it(tmp_path):
    from mcseg_tpu.utils.checkpoint import _state_to_dict, load_checkpoint

    prefix = str(tmp_path / "ckpt_v1")
    with gzip.open(os.path.join(FIXDIR, "ckpt_v1.msgpack.gz"), "rb") as f:
        blob = f.read()
    with open(prefix + ".msgpack", "wb") as f:
        f.write(blob)
    shutil.copy(os.path.join(FIXDIR, "ckpt_v1.config.json"), prefix + ".config.json")
    state, _ = load_checkpoint(prefix)
    want = serialization.to_state_dict(jax.device_get(_state_to_dict(state)))
    got = msgpack_compat.restore(blob)
    _assert_leaf(got, want, "")
    leaves = jax.tree.leaves(got)
    assert len(leaves) > 100 and int(got["step"]) == 1234


def test_refuses_what_flax_does_not_write():
    with pytest.raises(ValueError):
        msgpack_compat.unpackb(msgpack_compat.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError):
        msgpack_compat.unpackb(b"\xd4\x05\x00")  # ext type 5
    with pytest.raises(TypeError):
        msgpack_compat.packb({"a": object()})
