"""Serve CLI — an HTTP inference endpoint around the port's
``train.serving.Predictor``; counterpart of the JAX package's
``cli/serve.py``, with the same routes and replies:

  GET  /healthz        -> {"status": "ok", ...model/tree info...}
  POST /v1/predict     -> segmentation of the POSTed image bytes
       body: PNG bytes (other formats need cv2 on the host)
       query params:
         level  : hierarchy level of the returned class map
                  (default: deepest level)
         format : png (default) | json
       response:
         png  -> image/png, uint8 class-id map at model resolution
                 (img_size x img_size); header X-Classes lists the level's
                 class names in id order
         json -> {"level": L, "classes": [...], "class_map": [[...]]}

Preprocessing is the eval pipeline's: decode -> [0,1] -> bilinear resize to
img_size -> normalize(0.5, 0.5) -> grayscale broadcast to 3 channels.

The predictor is one in-process instance guarded by a lock; the card runs
one forward at a time anyway. ``--ensemble best|last`` serves the fold
ensemble of a train run directory, ``--tta True`` adds the flip TTA and
``--quantize True`` runs the convs in int8, as in the JAX CLI;
``--device`` is new (default cuda).
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .common import parse_bool as _bool


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Serve a trained model over HTTP (PyTorch port)")
    p.add_argument("--model-weights", type=str, required=True,
                   help="the port's .pt state_dict, or a <name>.ckpt "
                        "directory written by its train CLI, or a train "
                        "run dir (fold_N/ layout) with --ensemble")
    p.add_argument("--tree-root", type=str, required=True)
    p.add_argument("--class-map", type=str, required=True)
    p.add_argument("--img-size", type=int, default=352)
    p.add_argument("--model-type", type=int, default=0, choices=[0, 1])
    p.add_argument("--model-select", type=int, default=0, choices=[0, 1])
    p.add_argument("--config", type=str, default="")
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--quantize", type=str, default="False",
                   help="int8 PTQ of the serving forward (train/quantize.py)")
    p.add_argument("--ensemble", type=str, default="",
                   help="'best' or 'last': treat --model-weights as a run "
                        "dir and fold-ensemble every fold_N/<which>.ckpt")
    p.add_argument("--tta", type=str, default="False",
                   help="hflip test-time augmentation inside the forward "
                        "(2x compute per request)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    p.add_argument("--io", type=str, default="f32", choices=["f32", "u8"],
                   help="f32: host-normalized float input. u8: the host "
                        "decodes and resizes in float32, re-quantizes the "
                        "resized pixels to uint8 and ships those; "
                        "normalization runs on the device. u8 mode rejects "
                        "non-8-bit uploads (400)")
    p.add_argument("--warmup", type=str, default="True",
                   help="run a batch-1 forward before accepting requests")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def preprocess_bytes(data: bytes, img_size: int, io: str = "f32"):
    """Uploaded image bytes -> batch-1 model input: the dataset's val-mode
    chain (decode -> [0,1] -> resize -> normalize(.5,.5) -> gray broadcast
    to 3 channels). ``io="u8"``: same decode and resize, then the resized
    pixels are re-quantized to uint8 — (1, S, S) for gray, (1, S, S, 3) for
    color — for the Predictor to normalize on the device."""
    import numpy as np

    from ..data import transforms as T
    from ..data.dataset import decode_image_bytes_compact

    try:
        img = decode_image_bytes_compact(data)
    except ValueError as e:
        raise ValueError(f"request body is not a decodable image ({e})")
    if io == "u8" and img.dtype != np.uint8:
        # 16-bit pixels carry values > 255 through the training decode
        # convention (/255, not /dtype-max); uint8 would clip them
        raise ValueError(
            f"--io u8 requires 8-bit images (decoded dtype {img.dtype}); "
            "use the default f32 mode for deeper bit depths")
    x = img.astype(np.float32) / 255.0
    x = T.resize_bilinear_np(x, (img_size, img_size))
    if x.ndim == 2:
        x = x[..., None]
    if io == "u8":
        x = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
        if x.shape[-1] == 1:
            x = x[..., 0]
        return x[None]
    x = T.normalize(x)
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return x[None]


def make_server(predictor, tree, img_size: int, host: str = "127.0.0.1",
                port: int = 0, max_body_bytes: int = 64 << 20,
                hierarchical: bool = True,
                io: str = "f32") -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` binds an
    ephemeral port (``server.server_address[1]`` has the real one).
    ``hierarchical=False`` serves a flat model: one class map over the
    tree's leaf classes, level 0 only."""
    import numpy as np

    from ..data.png import encode_png_gray8

    level_names = ([list(l) for l in tree.levels] if hierarchical
                   else [list(tree.leaf_names)])
    n_out = len(level_names)
    lock = threading.Lock()
    info = {
        "status": "ok",
        "img_size": img_size,
        "hierarchical": hierarchical,
        "num_levels": n_out,
        "classes_per_level": [len(l) for l in level_names],
        "levels": level_names,
    }

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, info)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/v1/predict":
                self._json(404, {"error": "not found"})
                return
            try:
                q = parse_qs(url.query)
                fmt = q.get("format", ["png"])[0]
                level = int(q.get("level", [n_out - 1])[0])
                if not 0 <= level < n_out:
                    raise ValueError(
                        f"level must be in [0, {n_out - 1}]")
                if fmt not in ("png", "json"):
                    raise ValueError("format must be png or json")
                n = int(self.headers.get("Content-Length", 0))
                if n <= 0:
                    raise ValueError("empty request body")
                if n > max_body_bytes:
                    # drain the body so the client's send completes before
                    # the 413; replying mid-upload breaks the connection
                    left = n
                    while left > 0:
                        chunk = self.rfile.read(min(left, 1 << 20))
                        if not chunk:
                            return
                        left -= len(chunk)
                    self._json(413, {"error": f"body exceeds "
                                              f"{max_body_bytes} bytes"})
                    return
                if fmt == "png" and len(level_names[level]) > 256:
                    raise ValueError(
                        "png class maps hold ids 0..255; this level has "
                        f"{len(level_names[level])} classes — use "
                        "format=json")
                x = preprocess_bytes(self.rfile.read(n), img_size, io=io)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            try:
                with lock:
                    out = predictor(x)
                cmap = np.asarray(out["class_maps"][level][0])
                names = level_names[level]
                if fmt == "json":
                    self._json(200, {"level": level, "classes": names,
                                     "class_map": cmap.tolist()})
                    return
                body = encode_png_gray8(cmap.astype(np.uint8))
            except Exception as e:  # a 500 reply beats a dropped connection
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Level", str(level))
            self.send_header("X-Classes", ",".join(names))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def build_server(args) -> ThreadingHTTPServer:
    """The Predictor and HTTP server that ``main`` runs for parsed ``args``
    (after the warm-up forward when ``--warmup`` asks for it); the caller
    serves and closes it."""
    from ..config.run import RunConfig
    from ..hierarchy.tree import ClassTree
    from ..train.serving import Predictor

    cfg = RunConfig(
        tree_root=args.tree_root,
        class_map=args.class_map,
        img_size=args.img_size,
        model_select=args.model_select,
        model_type=args.model_type,
        hrnet_yaml=args.config or None,
        compute_dtype=args.compute_dtype,
    )
    tree = ClassTree.from_json(cfg.tree_root, cfg.class_map)
    # u8 class maps whenever the tree allows (the PNG reply is u8 anyway)
    cm_dtype = ("uint8" if all(len(l) <= 256 for l in tree.levels)
                else "int32")
    weights = (Predictor.fold_checkpoints(args.model_weights, args.ensemble)
               if args.ensemble else args.model_weights)
    predictor = Predictor(cfg, weights, tree=tree,
                          quantize=_bool(args.quantize),
                          outputs=("class_maps",), class_map_dtype=cm_dtype,
                          tta=_bool(args.tta), device=args.device)
    if _bool(args.warmup):
        print("warming up (batch-1 forward)...", flush=True)
        predictor.warmup(
            batch=1, input_dtype="uint8" if args.io == "u8" else "float32")
    return make_server(predictor, tree, args.img_size, args.host, args.port,
                       max_body_bytes=args.max_body_mb << 20,
                       hierarchical=args.model_type == 1, io=args.io)


def main(argv=None):
    server = build_server(get_args(argv))
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(POST /v1/predict, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
