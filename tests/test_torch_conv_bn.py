"""The fused 1x1 conv + BN + ReLU of the port (``ops/conv_bn_relu.py``, the
plain version the wrapper runs on the CPU) against the JAX package's tool
``tools/pallas_conv_bn_experiment.py``, on the CPU: its Pallas ``kernel``
in interpret mode with the tool's own BlockSpecs, and its ``xla_fused``.
Both are nested in the tool's ``main``, so they are taken from its source
with ``ast``. Also the wrapper's checks and the port's tool on the CPU.

Tolerance (``tools/conv_bn_experiment.py:tolerance``): one bf16 ulp of the
port's value (a value near a rounding boundary may round either way) plus
``K * 2^-24 * |a| * (|x| @ |w|)``, the worst-case error of an f32 sum of K
products taken in another order.
"""
import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    conv_bn_relu as k4,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.tools import (
    conv_bn_experiment as tool,
)

JAX_TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "pallas_conv_bn_experiment.py")
N, C, TILE_N = 256, 720, 128


def _jax_tool_functions():
    """``kernel``, ``xla_fused`` and ``pallas_fused`` from the JAX tool's
    ``main``, compiled as written, with ``interpret=True`` added to the one
    ``pl.pallas_call`` (the CPU has no TPU) and the tool's grid and
    BlockSpecs at N_PAD = 256, TILE_N = 128."""
    tree = ast.parse(JAX_TOOL.read_text())
    main = next(f for f in tree.body
                if isinstance(f, ast.FunctionDef) and f.name == "main")
    nested = {f.name: f for f in main.body if isinstance(f, ast.FunctionDef)}
    calls = [n for n in ast.walk(nested["pallas_fused"])
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "pallas_call"]
    assert len(calls) == 1
    calls[0].keywords.append(ast.keyword("interpret", ast.Constant(True)))
    module = ast.Module([nested[k] for k in ("kernel", "xla_fused",
                                             "pallas_fused")], [])
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "N_PAD": N, "C": C,
          "TILE_N": TILE_N}
    exec(compile(ast.fix_missing_locations(module), str(JAX_TOOL), "exec"),
         ns)
    return ns


@pytest.fixture(scope="module")
def case():
    x, w, a, b = tool.inputs(N, C, "cpu")
    jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
              for t in (x, w))
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    return (x, w, a, b), (jx, jw, ja, jb)


def _within(jax_out, port_out, x, w, a):
    got = torch.from_numpy(np.array(jax_out, np.float32))
    err = (got - port_out.float()).abs()
    assert bool((err <= tool.tolerance(x, w, a, port_out)).all()), \
        float(err.max())


@pytest.mark.parametrize("side", ["pallas_fused", "xla_fused"])
def test_plain_version_matches_jax_tool(case, side):
    (x, w, a, b), jargs = case
    before = k4.LAUNCHES
    got = k4.conv1x1_bn_relu(x, w, a, b)
    assert k4.LAUNCHES == before  # the CPU counts no launch
    assert got.dtype == torch.bfloat16 and got.shape == (N, C)
    want = _jax_tool_functions()[side](*jargs)
    assert want.dtype == jnp.bfloat16 and want.shape == (N, C)
    assert float(got.float().max()) > 0 and float(got.float().min()) == 0
    _within(want.astype(jnp.float32), got, x, w, a)


def test_inputs_are_the_jax_tools_draws():
    # tools/pallas_conv_bn_experiment.py:41-45 at N_PAD = 256
    rng = np.random.default_rng(0)
    want = [jnp.asarray(rng.standard_normal((N, C)), jnp.bfloat16),
            jnp.asarray(rng.standard_normal((C, C)) * 0.05, jnp.bfloat16),
            jnp.asarray(rng.uniform(0.5, 1.5, (C,)), jnp.float32),
            jnp.asarray(rng.standard_normal((C,)), jnp.float32)]
    for got, w in zip(tool.inputs(N, C, "cpu"), want):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


def test_wrapper_checks_raise():
    x, w, a, b = tool.inputs(64, 32, "cpu")
    with pytest.raises(TypeError, match="bf16 x and w"):
        k4.conv1x1_bn_relu(x.float(), w, a, b)
    with pytest.raises(TypeError, match="f32 a and b"):
        k4.conv1x1_bn_relu(x, w, a.double(), b)
    with pytest.raises(ValueError, match="x \\(N, C_in\\)"):
        k4.conv1x1_bn_relu(x[:, :16].contiguous(), w, a, b)
    with pytest.raises(ValueError, match="a and b must have shape"):
        k4.conv1x1_bn_relu(x, w, a[:16], b)
    with pytest.raises(ValueError, match="C_in % 16"):
        k4.conv1x1_bn_relu(x[:, :24].contiguous(), w[:24].contiguous(), a, b)
    with pytest.raises(ValueError, match="C_out % 8"):
        k4.conv1x1_bn_relu(x, w[:, :12].contiguous(), a[:12].contiguous(),
                           b[:12].contiguous())
    with pytest.raises(ValueError, match="contiguous x"):
        k4.conv1x1_bn_relu(x.t().contiguous().t(), w, a, b)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="x 16-byte aligned"):
        k4.conv1x1_bn_relu(flat[1:].view(64, 32), w, a, b)


def test_tool_runs_on_cpu_and_prints_one_json_line(capsys):
    row = tool.run(b=1, h=9, w=9, c=32, tile_n=16, steps=1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == row
    assert set(row) >= {"shape", "max_abs_err", "library_max_abs_err",
                        "library_ms", "kernel_ms", "library_TFs",
                        "kernel_TFs", "bound_ms", "bound_by", "card"}
    assert row["shape"] == "(96,32)x(32,32)" and row["device"] == "cpu"
    assert row["max_abs_err"] == 0.0 and row["within_tolerance"]
    # a CPU run times no device
    assert row["kernel_ms"] is None and row["card"] is None


def test_bound_at_the_tools_shape():
    bnd = tool.bound(96256, 720, 720)
    assert bnd["flop"] == 99_798_220_800 and bnd["bytes"] == 278_259_840
    assert bnd["bound_by"] == "operations"
    assert abs(bnd["bound_ms"] - 0.1009) < 1e-4


@pytest.mark.parametrize("shape", [(720, 720), (48, 64), (16, 248)])
def test_k_major_copy_of_w(shape):
    """The wrapper hands the kernel w (C_in, C_out) as a fresh contiguous
    (C_out, C_in) copy, so its TMA loads read K-major rows and a weight
    changed in place after a call cannot be read stale."""
    w = torch.randn(shape).to(torch.bfloat16)
    wt = k4._k_major(w)
    assert wt.shape == shape[::-1] and wt.dtype == torch.bfloat16
    assert wt.is_contiguous() and wt.data_ptr() % 16 == 0
    assert torch.equal(wt, w.t())
    assert wt.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()
    w.mul_(2)
    assert not torch.equal(wt, w.t())

