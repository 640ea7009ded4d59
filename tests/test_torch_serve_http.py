"""The port's HTTP host (``mcseg_tpu_torch/tools/serve_http.py``) against
the JAX package's (``mcseg_tpu/tools/serve_http.py``): the same requests to
both servers, each around its own package's artifact of the same weights
(drn_d_14, 8 classes, 32x32, float32, batch 1, weights carried by
``params_from_jax``), get the same answers.

Each response's class map equals JAX's exactly; the multitask depth PNG
within 1 mm of JAX's (the two depth heads agree within 1e-4 m, and the mm
values are truncated). Errors: a missing plane, corrupt bytes and a wrong
geometry get 400 (the last one not under ``--auto_resize``), a body above
the limit 413. Planes decode through the native decoder and through PIL.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
from PIL import Image

import mcseg_tpu_torch.tools.serve_http as serve_http
from mcseg_tpu.core.config import DataConfig as JaxDataConfig
from mcseg_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from mcseg_tpu.core.config import ModelConfig as JaxModelConfig
from mcseg_tpu.core.config import TrainConfig as JaxTrainConfig
from mcseg_tpu.eval.serving import export_serving as jax_export_serving
from mcseg_tpu.tools.serve_http import make_server as jax_make_server
from mcseg_tpu.train.multitask import init_multitask_state as jax_init_multitask_state
from mcseg_tpu.train.state import create_train_state as jax_create_train_state
from mcseg_tpu_torch import native
from mcseg_tpu_torch.core.config import ExperimentConfig
from mcseg_tpu_torch.eval.serving import export_serving, load_serving
from mcseg_tpu_torch.utils.jax_weights import params_from_jax
from _torch_threads import torch_threads  # noqa: F401  (autouse: the worker's cores)


def _artifacts(root, input_ch, multitask=False):
    """(JAX artifact path, port artifact path) of one random state."""
    model = JaxModelConfig(net="drn_d_14", input_ch=input_ch, n_class=8, dtype="float32")
    cfg = JaxExperimentConfig(
        model=model,
        data=JaxDataConfig(src_dataset="synthetic", tgt_dataset="synthetic", batch_size=1,
                           train_img_shape=(32, 32), test_img_shape=(32, 32),
                           input_ch=input_ch),
        train=JaxTrainConfig())
    init = jax_init_multitask_state if multitask else jax_create_train_state
    state = init(model, cfg.train, jax.random.key(input_ch), img_shape=(32, 32))[0]
    to_np = jax.tree.map(np.asarray, (state.params, state.batch_stats))
    name = f"m{input_ch}{'mt' if multitask else ''}"
    jpath, ppath = str(root / f"{name}.shlo"), str(root / f"{name}.pt2")
    jax_export_serving(cfg, state.params, state.batch_stats, jpath, batch=1,
                       platforms=("cpu",))
    export_serving(ExperimentConfig.from_dict(cfg.to_dict()), params_from_jax(*to_np),
                   ppath, batch=1, device="cpu")
    return jpath, ppath


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = tmp_path_factory.mktemp("artifacts")
    return {"rgb": _artifacts(root, 3), "rgbd": _artifacts(root, 6),
            "multitask": _artifacts(root, 3, multitask=True)}


class _Running:
    """A server running in a thread, shut down on exit."""

    def __init__(self, srv):
        self.srv = srv
        self.url = f"http://127.0.0.1:{srv.server_address[1]}"

    def __enter__(self):
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc):
        self.srv.shutdown()
        self.srv.server_close()


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(url, payload):
    """(status, JSON body) of POST /predict."""
    body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _both(paths, payload, **kw):
    """The port's and JAX's answers to one request."""
    jpath, ppath = paths
    with _Running(serve_http.make_server(ppath, port=0, device="cpu", **kw)) as ours, \
            _Running(jax_make_server(jpath, port=0, **kw)) as theirs:
        return _post(ours.url, payload), _post(theirs.url, payload)


@pytest.fixture(params=["native", "pil"])
def route(request, monkeypatch):
    if request.param == "pil":
        monkeypatch.setenv("MCSEG_NO_NATIVE", "1")
    elif not native.available():
        pytest.fail(f"the native decoder did not build: {native.build_report()}")
    return request.param


def test_healthz_and_predict_match_jax(artifacts):
    jpath, ppath = artifacts["rgb"]
    img = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    with _Running(serve_http.make_server(ppath, port=0, device="cpu")) as ours:
        health = json.loads(urllib.request.urlopen(ours.url + "/healthz").read())
        assert health["net"] == "drn_d_14" and health["device"] == "cpu"
        code, resp = _post(ours.url, {"image": _png(img)})
        assert code == 200 and resp["shape"] == [32, 32]
        pred = _decode(resp["pred_png"])
        want = load_serving(ppath)({"image": img[None]})[0].numpy()
        np.testing.assert_array_equal(pred, want)
        assert sum(resp["classes"].values()) == 32 * 32
        code, err = _post(ours.url, {})
        assert code == 400 and "missing plane" in err["error"]
    (code, ours_resp), (jcode, theirs) = _both(artifacts["rgb"], {"image": _png(img)})
    assert code == jcode == 200
    np.testing.assert_array_equal(_decode(ours_resp["pred_png"]), _decode(theirs["pred_png"]))
    assert ours_resp["classes"] == theirs["classes"] and ours_resp["shape"] == theirs["shape"]


def test_depth_plane_matches_jax(artifacts, route):
    """RGB + a 16-bit millimetre depth PNG: HHA inside the artifact."""
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (32, 32, 3)).astype(np.uint8)
    dmm = (rng.rand(32, 32) * 4000 + 500).astype(np.uint16)
    before = dict(native.routes)
    (code, ours), (jcode, theirs) = _both(artifacts["rgbd"],
                                          {"image": _png(img), "depth": _png(dmm)})
    assert code == jcode == 200
    np.testing.assert_array_equal(_decode(ours["pred_png"]), _decode(theirs["pred_png"]))
    assert native.routes[route] == before[route] + 2  # both planes, by this route


def test_corrupt_bytes_get_400_as_jax(artifacts):
    payload = {"image": base64.b64encode(b"not a png").decode()}
    (code, ours), (jcode, theirs) = _both(artifacts["rgb"], payload)
    assert code == jcode == 400 and "error" in ours and "error" in theirs


def test_geometry_mismatch_400_unless_auto_resize_and_413(artifacts, route):
    big = np.random.RandomState(3).randint(0, 256, (64, 48, 3)).astype(np.uint8)
    payload = {"image": _png(big)}
    (code, ours), (jcode, theirs) = _both(artifacts["rgb"], payload)
    assert code == jcode == 400 and ours["error"] == theirs["error"]
    assert "--auto_resize" in ours["error"]
    (code, ours), (jcode, theirs) = _both(artifacts["rgb"], payload, allow_resize=True)
    assert code == jcode == 200 and ours["shape"] == [32, 32]
    if route == "native":  # JAX's server resizes with its native decoder too
        np.testing.assert_array_equal(_decode(ours["pred_png"]), _decode(theirs["pred_png"]))
    (code, _), (jcode, _) = _both(artifacts["rgb"], payload, max_body=1024)
    assert code == jcode == 413


def test_multitask_depth_png_matches_jax(artifacts):
    img = np.random.RandomState(4).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    (code, ours), (jcode, theirs) = _both(artifacts["multitask"], {"image": _png(img)})
    assert code == jcode == 200
    np.testing.assert_array_equal(_decode(ours["pred_png"]), _decode(theirs["pred_png"]))
    dmm, jdmm = _decode(ours["depth_mm_png"]), _decode(theirs["depth_mm_png"])
    assert dmm.shape == (32, 32) and dmm.dtype == np.uint16
    assert np.abs(dmm.astype(np.int64) - jdmm.astype(np.int64)).max() <= 1
    _, depth = load_serving(artifacts["multitask"][1])({"image": img[None]})
    np.testing.assert_array_equal(
        dmm, np.clip(depth[0].numpy() * 1000.0, 0, 65535).astype(np.uint16))


def test_main_serves_until_shut_down(artifacts, monkeypatch, capsys):
    """``main(argv, device="cpu")``: the command line builds the server,
    says where and with which decoder, and answers."""
    built = []
    real = serve_http.make_server

    def recording(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    monkeypatch.setattr(serve_http, "make_server", recording)
    t = threading.Thread(target=serve_http.main, args=(
        [artifacts["rgb"][1], "--port", "0", "--max_body_mb", "1"],), kwargs={"device": "cpu"},
        daemon=True)
    t.start()
    for _ in range(1200):  # the artifact loads before the socket opens
        if built:
            break
        threading.Event().wait(0.05)
    assert built
    url = f"http://127.0.0.1:{built[0].server_address[1]}"
    try:
        health = json.loads(urllib.request.urlopen(url + "/healthz", timeout=60).read())
        assert health["input_spec"]["image"]["shape"] == [1, 32, 32, 3]
        assert built[0].RequestHandlerClass.max_body == 1024 * 1024
    finally:
        built[0].shutdown()
    t.join(timeout=60)
    assert not t.is_alive()
    out = capsys.readouterr().out
    assert f":{built[0].server_address[1]} " in out
    assert f"decoder: {serve_http.decode_route()}" in out
