"""The PyTorch port stands alone: importing it (and its serve, train,
predict_eval, export and agreement CLIs, its exporter, its donor importer,
its device-resident training set and its native sample factory) pulls in
neither jax nor any module of the JAX package,
and the train and offline-eval paths load no cv2, sklearn, orbax or
tensorflow (the card's machine has none of them); no source file of the
port imports them at module level, and ``chip_smoke.py`` refuses to run
without a CUDA device or outside the repository."""
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "restrictive_hierarchical_semantic_segmentation_tpu_torch"
JAX_PKG = "restrictive_hierarchical_semantic_segmentation_tpu"


def _forbidden(name: str) -> bool:
    # exact names or their submodules: the port's own name starts with the
    # JAX package's, so a bare prefix test would flag the port itself
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "flax", JAX_PKG))


def test_forbidden_matches_exact_names_only():
    assert _forbidden(JAX_PKG) and _forbidden(JAX_PKG + ".ops")
    assert _forbidden("jax.numpy")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".ops")
    assert not _forbidden("jaxtyping")


def _modules_after(imports: str) -> list:
    """The modules loaded by a fresh interpreter after ``imports``."""
    code = (f"import json, sys\n{imports}\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_and_serve_cli_import_no_jax():
    mods = _modules_after(
        f"import {PORT}\n"
        f"import {PORT}.cli.serve, {PORT}.train.serving, {PORT}.bridge\n"
        f"import {PORT}.models, {PORT}.ops, {PORT}.data.dataset\n"
        f"import {PORT}.train.steps, {PORT}.train.state\n"
        f"import {PORT}.losses.hierarchical, {PORT}.metrics.segmentation\n"
        f"import {PORT}.data.synthetic, {PORT}.data.target_factory\n"
        f"import {PORT}.models.backbones.unet, {PORT}.ops.conv_bn_relu\n"
        f"import {PORT}.tools.conv_bn_experiment\n"
        f"import {PORT}.train.quantize, {PORT}.ops.int8_conv")
    assert PORT in mods and f"{PORT}.train.steps" in mods
    assert f"{PORT}.train.quantize" in mods and f"{PORT}.ops.int8_conv" in mods
    assert f"{PORT}.models.backbones.unet" in mods
    assert f"{PORT}.tools.conv_bn_experiment" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_deployment_modules_import_no_jax():
    """The export module and CLI and the donor importer (which reads
    ``.pth`` files with torch alone, where the JAX one converts to flax)."""
    mods = _modules_after(f"import {PORT}.train.export\n"
                          f"import {PORT}.train.torch_import\n"
                          f"import {PORT}.cli.export")
    for name in ("train.export", "train.torch_import", "cli.export"):
        assert f"{PORT}.{name}" in mods
    assert [m for m in mods if _forbidden_on_train_path(m)] == []


def test_data_side_modules_import_no_jax_or_cv2():
    """The agreement CLI, the device-resident training set and the native
    sample factory's bridge: no jax, no JAX package, no cv2; and the
    agreement CLI imports scipy only inside the call that needs it."""
    names = ("cli.agreement", "data.device_augment", "data.native")
    mods = _modules_after("".join(f"import {PORT}.{n}\n" for n in names))
    for name in names:
        assert f"{PORT}.{name}" in mods
    assert [m for m in mods if _forbidden_on_train_path(m)] == []
    assert [m for m in mods if m == "scipy" or m.startswith("scipy.")] == []


def test_train_path_data_imports_no_cv2():
    # the card's machine has no OpenCV: the synthetic data and the target
    # factory that feed the train step must not need it
    mods = _modules_after(f"import {PORT}.data.synthetic\n"
                          f"import {PORT}.data.target_factory")
    assert f"{PORT}.data.synthetic" in mods
    assert [m for m in mods if m == "cv2" or m.startswith("cv2.")] == []


# absent on the card's machine: the training path must not need them
_TRAIN_PATH_FORBIDDEN = ("cv2", "sklearn", "orbax", "tensorflow")


def _forbidden_on_train_path(name: str) -> bool:
    return _forbidden(name) or any(
        name == top or name.startswith(top + ".")
        for top in _TRAIN_PATH_FORBIDDEN)


def test_train_cli_path_imports_no_cv2_sklearn_orbax_or_jax():
    mods = _modules_after(
        f"import {PORT}.cli.train, {PORT}.train.loop\n"
        f"import {PORT}.train.checkpoint, {PORT}.train.plateau\n"
        f"import {PORT}.data.loader, {PORT}.data.dataset\n"
        f"import {PORT}.data.transforms, {PORT}.utils.logging")
    assert f"{PORT}.train.loop" in mods and f"{PORT}.data.loader" in mods
    assert [m for m in mods if _forbidden_on_train_path(m)] == []


def test_predict_eval_path_imports_no_cv2_sklearn_orbax_or_jax():
    mods = _modules_after(f"import {PORT}.cli.predict_eval\n"
                          f"import {PORT}.train.evaluate\n"
                          f"import {PORT}.train.quantize")
    assert f"{PORT}.cli.predict_eval" in mods
    assert f"{PORT}.train.evaluate" in mods
    assert [m for m in mods if _forbidden_on_train_path(m)] == []


def test_port_sources_import_no_cv2_sklearn_orbax_at_module_level():
    # cv2 is imported only inside the decoders' fallback for formats other
    # than PNG (data/dataset.py:_decode_cv2); tensorflow only inside
    # MetricsLogger when TensorBoard is asked for
    late = {"cv2": {"dataset.py"}, "tensorflow": {"logging.py"}}
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        text = path.read_text()
        for name in _IMPORT.findall(text):
            top = name.split(".")[0]
            if top in _TRAIN_PATH_FORBIDDEN:
                assert path.name in late.get(top, ()), f"{path}: {name}"
        for name in re.findall(r"^(?:import|from)\s+([\w.]+)", text, re.M):
            assert name.split(".")[0] not in _TRAIN_PATH_FORBIDDEN, \
                f"{path}: imports {name} at module level"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([\w.]+)", re.M)


def test_port_sources_import_no_jax():
    files = sorted((REPO / PORT).rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _IMPORT.findall(path.read_text()):
            assert not _forbidden(name), f"{path}: imports {name}"


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_smoke(REPO, env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the rest of the repository
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = _run_smoke(tmp_path, dict(env, PYTHONPATH=""))
    assert alone.returncode != 0
    assert '"ok": true' not in alone.stdout
