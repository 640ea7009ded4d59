"""The port's reference-checkpoint import (``cli/import_torch.py``,
``utils/torch_import.py``, ``models/factory.py widen_first_conv_params``)
against the JAX package's, bit for bit.

A reference ``.pth.tar`` (``{epoch, args, g_state_dict, f1_state_dict,
f2_state_dict}``: the independent torch DRN-D-22 of
``tests/test_golden_drn.py`` with randomized BN, and two 1x1 heads) and a
bare 3-channel trunk state dict (with an ImageNet ``fc``) go through JAX's
``import_torch.main`` and the port's. The JAX checkpoint is read with
flax's own ``msgpack_restore`` and carried over by ``params_from_jax``;
every imported tensor equals the port's, and the full import equals its
torch source. The bare trunk is widened to ``input_ch`` 6, 4 and 1 (the
heads stay each side's own seeded initialization, so G alone is
compared). The fc->conv seeding and the walk order are held against JAX's
``import_torch_state_dict`` on a tiny module."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from mcseg_tpu.cli import import_torch as jax_import_torch
from mcseg_tpu.utils.torch_import import import_torch_state_dict as jax_import_sd
from mcseg_tpu_torch.cli import import_torch
from mcseg_tpu_torch.models.factory import widen_first_conv_params
from mcseg_tpu_torch.utils.checkpoint import load_params
from mcseg_tpu_torch.utils.jax_weights import params_from_jax, params_to_jax
from mcseg_tpu_torch.utils.torch_import import import_torch_state_dict
from tests.test_golden_drn import TorchDRND22
from tests.test_import_cli import _TorchHead
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)

NC = 7


def _trunk(seed, input_ch=3):
    torch.manual_seed(seed)
    tg = TorchDRND22(input_ch)
    with torch.no_grad():
        for m in tg.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn_like(m.running_mean) * 0.1)
                m.running_var.copy_(torch.rand_like(m.running_var) * 0.5 + 0.75)
                m.weight.copy_(torch.rand_like(m.weight) * 0.5 + 0.75)
                m.bias.copy_(torch.randn_like(m.bias) * 0.1)
    return tg


def _jax_params(prefix):
    with open(prefix + ".msgpack", "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    return params_from_jax(raw["params"], raw["batch_stats"])


def _both(tmp_path, torch_path, flags, capsys):
    jax_prefix, port_prefix = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_import_torch.main([torch_path, jax_prefix, *flags])
    jax_out = capsys.readouterr().out.splitlines()
    assert import_torch.main([torch_path, port_prefix, *flags], device="cpu") \
        == port_prefix + ".pt"
    port_out = capsys.readouterr().out.splitlines()
    assert jax_out[:-1] == port_out[:-1]  # the last line names the written file
    return _jax_params(jax_prefix), load_params(port_prefix)


def _assert_equal(got, want, names):
    for name in names:
        assert got[name].keys() == want[name].keys(), name
        for k in want[name]:
            assert got[name][k].dtype == want[name][k].dtype, (name, k)
            assert torch.equal(got[name][k], want[name][k]), (name, k)


def test_reference_checkpoint_imports_as_jax_does(tmp_path, capsys):
    tg, tf1, tf2 = _trunk(0), _TorchHead(NC), _TorchHead(NC)
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 7, "args": {"net": "drn_d_22", "input_ch": 3},
                "g_state_dict": tg.state_dict(), "f1_state_dict": tf1.state_dict(),
                "f2_state_dict": tf2.state_dict()}, path)
    want, (got, cfg) = _both(tmp_path, path, ["--net", "drn_d_22", "--input_ch", "3",
                                              "--n_class", str(NC), "--dtype", "float32"], capsys)
    _assert_equal(got, want, ("G", "F1", "F2"))
    assert cfg.model.net == "drn_d_22" and cfg.model.dtype == "float32"
    # and the port's import is its torch source, tensor for tensor
    src = [t for k, t in tg.state_dict().items() if not k.endswith("num_batches_tracked")]
    mine = [t for k, t in got["G"].items() if not k.endswith("num_batches_tracked")]
    assert sorted(t.numel() for t in src) == sorted(t.numel() for t in mine)
    assert torch.equal(got["G"]["conv0.weight"], tg.stem[0].weight)
    assert torch.equal(got["G"]["bn0.running_var"], tg.stem[1].running_var)
    assert torch.equal(got["G"]["layer8.conv0.weight"], tg.layer8[0].weight)
    assert torch.equal(got["F2"]["score.weight"], tf2.score.weight)
    assert torch.equal(got["F1"]["score.bias"], tf1.score.bias)


@pytest.mark.parametrize("input_ch", [6, 4, 1])
def test_bare_trunk_widens_as_jax_does(tmp_path, capsys, input_ch):
    tg = _trunk(1)
    sd = dict(tg.state_dict())
    sd["fc.weight"] = torch.randn(1000, 512, 1, 1)  # an ImageNet head, dropped
    sd["fc.bias"] = torch.randn(1000)
    path = str(tmp_path / "imagenet.pth")
    torch.save(sd, path)
    want, (got, cfg) = _both(tmp_path, path, ["--net", "drn_d_22", "--input_ch", str(input_ch),
                                              "--n_class", str(NC)], capsys)
    _assert_equal(got, want, ("G",))
    assert cfg.model.input_ch == input_ch
    k = got["G"]["conv0.weight"]
    w = tg.stem[0].weight.detach()
    if input_ch == 1:
        assert torch.equal(k, w[:, 0:1] + w[:, 1:2] + w[:, 2:3])
    else:
        assert torch.equal(k[:, :3], w)
        torch.testing.assert_close(k[:, 3:], w.mean(1, keepdim=True).expand(-1, input_ch - 3,
                                                                            -1, -1))


def _tiny_port_sd(input_ch):
    """A tiny port-side state dict: a first conv (``input_ch`` inputs), a
    BN, two same-shape convs whose state-dict order (layer10 first) is not
    the natural order, and an fc6-style 2x2 conv that a Linear seeds."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return {"layer10.weight": r(4, 4, 3, 3), "conv0.weight": r(4, input_ch, 3, 3),
            "bn0.weight": r(4), "bn0.bias": r(4), "bn0.running_mean": r(4),
            "bn0.running_var": r(4).abs(), "bn0.num_batches_tracked": torch.tensor(0),
            "layer2.weight": r(4, 4, 3, 3), "fc6.weight": r(5, 4, 2, 2), "fc6.bias": r(5)}


def _tiny_torch_sd():
    g = torch.Generator().manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return {"stem.0.weight": r(4, 3, 3, 3), "stem.1.weight": r(4), "stem.1.bias": r(4),
            "stem.1.running_mean": r(4), "stem.1.running_var": r(4).abs(),
            "stem.1.num_batches_tracked": torch.tensor(3),
            "a.weight": r(4, 4, 3, 3), "b.weight": r(4, 4, 3, 3),
            "fc6.weight": r(5, 16), "fc6.bias": r(5)}


@pytest.mark.parametrize("input_ch", [3, 6])
def test_tiny_module_fc_seeding_and_order_match_jax(input_ch):
    port_sd, torch_sd = _tiny_port_sd(input_ch), _tiny_torch_sd()
    p, s = params_to_jax({"G": port_sd})
    jp, js = jax_import_sd(torch_sd, p["G"], s["G"])
    want = params_from_jax({"G": jax.tree.map(np.asarray, jp), "F1": {}, "F2": {}},
                           {"G": jax.tree.map(np.asarray, js)})["G"]
    got = import_torch_state_dict(torch_sd, port_sd)
    want["bn0.num_batches_tracked"] = port_sd["bn0.num_batches_tracked"]
    _assert_equal({"G": got}, {"G": want}, ("G",))
    assert torch.equal(got["fc6.weight"], torch_sd["fc6.weight"].reshape(5, 4, 2, 2))
    assert torch.equal(got["layer2.weight"], torch_sd["a.weight"])  # natural order
    assert torch.equal(got["layer10.weight"], torch_sd["b.weight"])
    want_conv0 = widen_first_conv_params(torch_sd["stem.0.weight"], input_ch)
    assert torch.equal(got["conv0.weight"], want_conv0)


def test_unmatched_tensor_raises_as_in_jax():
    port_sd, torch_sd = _tiny_port_sd(3), _tiny_torch_sd()
    del torch_sd["fc6.bias"]
    p, s = params_to_jax({"G": port_sd})
    with pytest.raises(ValueError, match="no torch tensor found for params:fc6/bias"):
        jax_import_sd(torch_sd, p["G"], s["G"])
    with pytest.raises(ValueError, match="no torch tensor found for params:fc6/bias"):
        import_torch_state_dict(torch_sd, port_sd)
