"""A minimal serving host around an exported artifact.

    python -m mcseg_tpu_torch.tools.export_serving runs/x/last --out m.pt2
    python -m mcseg_tpu_torch.tools.serve_http m.pt2 --port 8000

Standard library only (ThreadingHTTPServer); the model is the artifact of
``eval/serving.py``, loaded once at start, so a request is decode -> one
artifact call -> PNG encode.

API (JSON in, JSON out):
  GET  /healthz    -> the artifact's manifest (input spec, device, n_class)
  POST /predict    -> {"image": <base64 PNG>, "depth"?: <base64 16-bit PNG,
                       millimetres>, "hha"?/"ir"?/"boundary"?: <base64 PNG>}
                   -> {"pred_png": <base64 gray PNG of train ids>,
                       "shape": [H, W], "classes": {id: pixel_count}}
                      plus "depth_mm_png" (16-bit PNG) for a multitask
                      artifact

A plane whose size differs from the input spec gets HTTP 400 unless the
server runs with ``--auto_resize``; undecodable bytes get 400, a body above
``--max_body_mb`` 413. Planes decode with the port's native decoder, or
with PIL where it cannot be built; ``native.routes`` counts the files each
route decoded. The artifact has a static batch B: a request's planes are
tiled to B and row 0 of each output is returned (export with --batch 1 for
latency).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from mcseg_tpu_torch import native
from mcseg_tpu_torch.data.transforms import encode_png


def decode_route() -> str:
    """'native' when the native decoder is built here, else 'pil'."""
    return "native" if native.available() else "pil"


def _decode_plane(b64: str, kind: str, h: int, w: int,
                  allow_resize: bool = False) -> np.ndarray:
    """base64 PNG -> the decoded plane at (h, w): uint8 [h,w,3] for 'image'
    and 'hha', float32 metres [h,w] for 'depth' (16-bit millimetres), uint8
    [h,w] for 'ir' and 'boundary'.

    A plane of another size raises ValueError (HTTP 400) instead of being
    resized behind a 200, unless ``allow_resize``."""
    from PIL import Image

    raw = base64.b64decode(b64)
    native_size = Image.open(io.BytesIO(raw)).size  # reads the header only
    if native_size != (w, h) and not allow_resize:
        raise ValueError(
            f"plane {kind!r} is {native_size[0]}x{native_size[1]} but the "
            f"artifact input spec is {w}x{h}; re-encode at the spec geometry "
            "or start the server with --auto_resize")
    if native.available():
        with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
            f.write(raw)
            path = f.name
        try:
            if kind in ("image", "hha"):
                out = native.decode_rgb(path, h, w)
            elif kind == "depth":
                out = native.decode_depth16(path, h, w)
            else:  # ir / boundary
                out = native.decode_gray(path, h, w)
        finally:
            os.unlink(path)
        native.note("native")
        return out
    img = Image.open(io.BytesIO(raw))
    if kind in ("image", "hha"):
        img = img.convert("RGB")
    elif kind in ("ir", "boundary"):
        img = img.convert("L")
    if img.size != (w, h):
        img = img.resize((w, h), Image.BILINEAR if kind == "image" else Image.NEAREST)
    arr = np.asarray(img)
    native.note("pil")
    if kind == "depth":
        return arr.astype(np.float32) * 0.001
    return arr


class _Model:
    """The loaded artifact and its manifest. Calls are serialized: the
    card runs one request at a time anyway."""

    def __init__(self, artifact_path: str, allow_resize: bool = False, device=None):
        from mcseg_tpu_torch.eval.serving import load_serving

        self.call = load_serving(artifact_path, device)
        self.manifest = self.call.manifest
        self.spec = self.manifest["input_spec"]
        self.allow_resize = allow_resize
        self._lock = threading.Lock()

    def predict(self, planes: dict) -> dict:
        batch = {}
        for key, meta in self.spec.items():
            if key not in planes:
                raise KeyError(f"request is missing plane {key!r} "
                               f"(artifact input spec: {sorted(self.spec)})")
            shape = meta["shape"]  # [B, H, W(, C)]
            arr = _decode_plane(planes[key], key, shape[1], shape[2], self.allow_resize)
            arr = np.asarray(arr, dtype=np.dtype(meta["dtype"]))
            batch[key] = np.broadcast_to(arr, tuple(shape)).copy()
        with self._lock:
            out = self.call(batch)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return {name: o[0].cpu().numpy() for name, o in zip(self.manifest["outputs"], out)}


class _Handler(BaseHTTPRequestHandler):
    model: _Model = None  # set by make_server
    # oversized (or bogus Content-Length) bodies are refused before they
    # are read: one request must not exhaust the host's memory
    max_body: int = 64 * 1024 * 1024
    # headers and body leave as two writes: without TCP_NODELAY the second
    # waits on the client's delayed ACK (~40 ms a response)
    disable_nagle_algorithm = True

    def _send(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._send(200, self.model.manifest)
        else:
            self._send(404, {"error": "unknown path; use /healthz or /predict"})

    def do_POST(self):  # noqa: N802
        if self.path != "/predict":
            self._send(404, {"error": "unknown path; use /predict"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > self.max_body:
                self._send(413, {"error": f"request body {n} bytes exceeds "
                                          f"the {self.max_body}-byte limit"})
                return
            outs = self.model.predict(json.loads(self.rfile.read(n)))
            pred = outs["pred"]
            ids, counts = np.unique(pred, return_counts=True)
            payload = {
                "pred_png": base64.b64encode(encode_png(pred.astype(np.uint8))).decode(),
                "shape": list(pred.shape),
                "classes": {int(i): int(c) for i, c in zip(ids, counts)},
            }
            if "depth" in outs:  # multitask artifacts: metric depth as a mm PNG
                dmm = np.clip(outs["depth"] * 1000.0, 0, 65535).astype(np.uint16)
                payload["depth_mm_png"] = base64.b64encode(encode_png(dmm)).decode()
            self._send(200, payload)
        except (KeyError, ValueError, OSError) as e:
            # OSError covers PIL's UnidentifiedImageError on corrupt bytes:
            # the client gets the documented JSON 400, not a dropped connection
            self._send(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # noqa: BLE001 (the server keeps answering)
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):  # quiet by default
        pass


def make_server(artifact: str, host: str = "127.0.0.1", port: int = 8000,
                allow_resize: bool = False, max_body: int = _Handler.max_body,
                device=None) -> ThreadingHTTPServer:
    """Build (but do not start) the server around ``artifact``; a test
    binds port 0 and runs ``serve_forever`` in a thread."""
    handler = type("Handler", (_Handler,),
                   {"model": _Model(artifact, allow_resize, device), "max_body": max_body})
    return ThreadingHTTPServer((host, port), handler)


def main(argv=None, device=None):
    """Serve until interrupted. ``device``: the device the artifact must
    run on (default: the one its manifest names)."""
    p = argparse.ArgumentParser("serve_http",
                                description="Serve an exported artifact over HTTP")
    p.add_argument("artifact", help="path from tools/export_serving --out")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--auto_resize", action="store_true",
                   help="resize wrong-geometry client planes to the artifact "
                        "spec instead of rejecting them with HTTP 400")
    p.add_argument("--max_body_mb", type=int, default=64,
                   help="reject request bodies larger than this (HTTP 413)")
    args = p.parse_args(argv)
    srv = make_server(args.artifact, args.host, args.port,
                      allow_resize=args.auto_resize,
                      max_body=args.max_body_mb * 1024 * 1024, device=device)
    print(f"serving {args.artifact} on http://{args.host}:{srv.server_address[1]} "
          f"(spec: {sorted(srv.RequestHandlerClass.model.spec)}, "
          f"decoder: {decode_route()})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
