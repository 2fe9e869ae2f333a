"""The port's serving path on the CPU against the JAX package: the
Predictor against ``model.apply(train=False)`` + argmax on the same
variables (f32, u8 gray and u8 RGB input), ``preprocess_bytes`` against the
JAX CLI's, the port's PNG decoder against cv2, and an in-process round
trip through ``make_server``."""
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from restrictive_hierarchical_semantic_segmentation_tpu.cli import (
    serve as jax_serve,
)
from restrictive_hierarchical_semantic_segmentation_tpu.models.hierarchical import (
    build_model as jax_build_model,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.bridge import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.cli import (
    serve as port_serve,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.config.run import (
    RunConfig,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.data.png import (
    PNG_SIGNATURE,
    decode_png,
    encode_png_gray8,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train.serving import (
    Predictor,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.utils.device import (
    resolve_device,
)
from torch_donor_common import donor_state_dict
from torch_port_common import ASSETS, ATOL, RTOL, jax_variables, tiny_configs, trees

SIZE = 32
TINY_YAML = """MODEL:
  ALIGN_CORNERS: true
  EXTRA:
    FINAL_CONV_KERNEL: 1
    STAGE1: {NUM_MODULES: 1, NUM_BRANCHES: 1, BLOCK: BOTTLENECK, NUM_BLOCKS: [1], NUM_CHANNELS: [4]}
    STAGE2: {NUM_MODULES: 1, NUM_BRANCHES: 2, BLOCK: BASIC, NUM_BLOCKS: [1, 1], NUM_CHANNELS: [4, 8]}
    STAGE3: {NUM_MODULES: 1, NUM_BRANCHES: 3, BLOCK: BASIC, NUM_BLOCKS: [1, 1, 1], NUM_CHANNELS: [4, 8, 16]}
    STAGE4: {NUM_MODULES: 1, NUM_BRANCHES: 4, BLOCK: BASIC, NUM_BLOCKS: [1, 1, 1, 1], NUM_CHANNELS: [4, 8, 16, 32]}
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny hierarchical HRNet on both sides with the same variables; the
    port's Predictor reads the topology from a reference-format YAML."""
    jtree, ptree = trees("default")
    jcfg, _ = tiny_configs()
    tmp = tmp_path_factory.mktemp("torch_serving")
    (tmp / "tiny.yaml").write_text(TINY_YAML)
    jm = jax_build_model(jtree, 1, 1, jcfg)
    params, stats = jax_variables(jm, np.zeros((1, SIZE, SIZE, 3),
                                               np.float32), train=False)
    sd = state_dict_from_flax(params, stats)
    cfg = RunConfig(tree_root=str(ASSETS / "class_tree_tl.json"),
                    class_map=str(ASSETS / "class_map.csv"), img_size=SIZE,
                    model_select=1, model_type=1,
                    hrnet_yaml=str(tmp / "tiny.yaml"),
                    compute_dtype="float32")
    pred = Predictor(cfg, sd, tree=ptree, device="cpu")
    apply = jax.jit(lambda x: jm.apply(
        {"params": params, "batch_stats": stats}, x, train=False))
    return {"pred": pred, "apply": apply, "cfg": cfg, "sd": sd,
            "tree": ptree, "tmp": tmp}


def _jax_prep(x):
    """The JAX Predictor's on-device u8 normalization (serving.py _prep)."""
    if x.dtype != np.uint8:
        return jnp.asarray(x)
    x = jnp.asarray(x)
    if x.ndim == 3:
        x = x[..., None]
    x = (x.astype(jnp.float32) / 255.0 - 0.5) / 0.5
    return jnp.broadcast_to(x, x.shape[:-1] + (3,))


def _inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "f32":
        return rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    shape = (2, SIZE, SIZE) if kind == "u8_gray" else (2, SIZE, SIZE, 3)
    return rng.integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("kind", ["f32", "u8_gray", "u8_rgb"])
def test_predictor_matches_jax_apply(setup, kind):
    x = _inputs(kind)
    want = setup["apply"](_jax_prep(x))
    got = setup["pred"](x)
    for L, (g, w) in enumerate(zip(got["logits"], want.logits_per_level)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["probs"][L],
                                   np.asarray(want.probs_per_level[L]),
                                   rtol=RTOL, atol=ATOL)
        cmap = got["class_maps"][L]
        assert cmap.dtype == np.int32 and cmap.shape == w.shape[:3]
        top2 = np.sort(w, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(cmap[clear], w.argmax(-1)[clear])


def test_predictor_outputs_dtypes_and_weights_file(setup):
    cfg, sd, tree = setup["cfg"], setup["sd"], setup["tree"]
    path = setup["tmp"] / "weights.pt"
    torch.save(sd, str(path))
    pred = Predictor(cfg, str(path), tree=tree, outputs=("class_maps",),
                     class_map_dtype="uint8", device="cpu")
    x = _inputs("u8_gray")
    got = pred(x)
    assert set(got) == {"class_maps"}
    ref = setup["pred"](x)["class_maps"]
    for g, r in zip(got["class_maps"], ref):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="unknown Predictor outputs"):
        Predictor(cfg, sd, tree=tree, outputs=("features",), device="cpu")
    # a donor .pth under the reference's names loads as the same weights
    donor = setup["tmp"] / "donor.pth"
    params, stats = flax_from_state_dict(sd)
    torch.save(donor_state_dict(params, stats, 1), str(donor))
    got = Predictor(cfg, str(donor), tree=tree, outputs=("class_maps",),
                    class_map_dtype="uint8", device="cpu")(x)
    for g, r in zip(got["class_maps"], ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(FileNotFoundError):
        Predictor(cfg, str(setup["tmp"] / "best.ckpt"), tree=tree,
                  device="cpu")


def test_cuda_is_required_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


def _png_cases():
    rng = np.random.default_rng(11)
    grad = np.add.outer(np.arange(45), np.arange(38)) * 3
    return {
        "gray8": (rng.integers(0, 256, (45, 38)) // 2 + grad // 4)
        .astype(np.uint8),
        "rgb8": rng.integers(0, 256, (29, 41, 3)).astype(np.uint8),
        "rgba8": rng.integers(0, 256, (23, 17, 4)).astype(np.uint8),
        "gray16": (rng.integers(0, 65536, (31, 27)) // 2 + grad[:31, :27]
                   * 200).astype(np.uint16),
        "rgb16": rng.integers(0, 65536, (19, 21, 3)).astype(np.uint16),
    }


@pytest.mark.parametrize("name", ["gray8", "rgb8", "rgba8", "gray16",
                                  "rgb16"])
def test_png_decoder_matches_cv2(name):
    img = _png_cases()[name]
    if img.ndim == 3:  # cv2 writes BGR(A)
        code = cv2.COLOR_RGB2BGR if img.shape[2] == 3 else cv2.COLOR_RGBA2BGRA
        ok, png = cv2.imencode(".png", cv2.cvtColor(img, code))
    else:
        ok, png = cv2.imencode(".png", img)
    assert ok
    got = decode_png(png.tobytes())
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


def _filtered_png(img):
    """An 8-bit gray PNG whose rows cycle through all five filter types."""
    h, w = img.shape
    rows, prev = [], np.zeros(w, np.int64)
    for y in range(h):
        cur = img[y].astype(np.int64)
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        kind = y % 5
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prev
        elif kind == 3:
            f = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = cur - pred
        rows.append(bytes([kind]) + (f % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_decoder_all_filter_types_and_encoder():
    img = np.random.default_rng(5).integers(0, 256, (20, 13)).astype(np.uint8)
    png = _filtered_png(img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(decode_png(png), img)
    mine = encode_png_gray8(img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_UNCHANGED), img)
    with pytest.raises(ValueError):
        decode_png(b"not a png")


def _gray_png(w, h, raw):
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decoder_bounds_what_it_inflates():
    # 16 MB of zeros behind a 4x3 header: only the header's 15 bytes inflate
    img = decode_png(_gray_png(4, 3, bytes(16 << 20)))
    np.testing.assert_array_equal(img, np.zeros((3, 4), np.uint8))
    with pytest.raises(ValueError, match="exceeds"):
        decode_png(_gray_png(1 << 16, 1 << 15, b"\0"))
    with pytest.raises(ValueError, match="shorter"):
        decode_png(_gray_png(4, 3, bytes(14)))


@pytest.mark.parametrize("name", ["gray8", "rgb8", "gray16"])
def test_preprocess_bytes_matches_jax(name):
    img = _png_cases()[name]
    ok, png = cv2.imencode(".png", img if img.ndim == 2
                           else cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    for size in (24, 64):
        got = port_serve.preprocess_bytes(png.tobytes(), size)
        want = jax_serve.preprocess_bytes(png.tobytes(), size)
        assert got.shape == want.shape == (1, size, size, 3)
        assert got.dtype == want.dtype == np.float32
        # cv2's float INTER_LINEAR rounds on its own: ~2e-5 on [-1, 1]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    if img.dtype == np.uint8:
        u8 = port_serve.preprocess_bytes(png.tobytes(), 24, io="u8")
        assert u8.dtype == np.uint8
        assert u8.shape == ((1, 24, 24) if img.ndim == 2 else (1, 24, 24, 3))
    else:
        with pytest.raises(ValueError, match="8-bit"):
            port_serve.preprocess_bytes(png.tobytes(), 24, io="u8")


@pytest.fixture(scope="module")
def served(setup):
    tree = setup["tree"]
    server = port_serve.make_server(setup["pred"], tree, SIZE, "127.0.0.1",
                                    0, max_body_bytes=1 << 20)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(9).integers(0, 256, (40, 48)).astype(np.uint8)
    png = encode_png_gray8(img)
    expected = setup["pred"](port_serve.preprocess_bytes(png, SIZE))
    yield {"url": f"http://127.0.0.1:{server.server_address[1]}",
           "png": png, "expected": expected["class_maps"], "tree": tree}
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=60)


def test_server_healthz_and_png_reply(served):
    with urllib.request.urlopen(served["url"] + "/healthz", timeout=60) as r:
        info = json.loads(r.read())
    tree = served["tree"]
    assert info["status"] == "ok" and info["img_size"] == SIZE
    assert info["classes_per_level"] == list(tree.classes_per_level)
    with _post(served["url"] + "/v1/predict", served["png"]) as r:
        assert r.headers["Content-Type"] == "image/png"
        level = int(r.headers["X-Level"])
        assert r.headers["X-Classes"].split(",") == list(tree.levels[level])
        got = decode_png(r.read())
    assert level == tree.num_levels - 1
    np.testing.assert_array_equal(got, served["expected"][level][0])


def test_server_json_reply(served):
    with _post(served["url"] + "/v1/predict?format=json&level=0",
               served["png"]) as r:
        out = json.loads(r.read())
    assert out["level"] == 0
    assert out["classes"] == list(served["tree"].levels[0])
    np.testing.assert_array_equal(np.asarray(out["class_map"]),
                                  served["expected"][0][0])


@pytest.mark.parametrize("path,body,code", [
    ("/v1/predict", b"", 400),
    ("/v1/predict", b"not an image", 400),
    ("/v1/predict?level=9", None, 400),
    ("/v1/nope", None, 404),
    ("/v1/predict", b"\0" * (2 << 20), 413),
])
def test_server_bad_requests(served, path, body, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"] + path, served["png"] if body is None else body)
    assert e.value.code == code


def test_serve_cli_arguments():
    args = port_serve.get_args([
        "--model-weights", "w.pt", "--tree-root", "t", "--class-map", "c",
        "--img-size", "64", "--model-type", "1", "--model-select", "1",
        "--port", "0", "--device", "cpu", "--io", "u8"])
    assert args.img_size == 64 and args.device == "cpu" and args.io == "u8"
    assert args.compute_dtype == "bfloat16" and args.host == "127.0.0.1"
