"""The fused 1x1 conv + BN + ReLU experiment on the card; counterpart of the
JAX package's ``tools/pallas_conv_bn_experiment.py``.

The HRNet shared head's 1x1 conv (720 -> 720 at 1/4 resolution, the
largest single matmul-shaped op of the model) followed by its eval-mode
BatchNorm (a per-channel scale and shift) and ReLU, at the JAX tool's
shapes and on its inputs (numpy ``default_rng(0)``, rows padded to the
tile), two ways:

  A) the library path: one cuBLAS ``torch.matmul(x, w)`` in bf16, then the
     epilogue in eager PyTorch (a yardstick, not the oracle: its product is
     rounded to bf16 before the epilogue);
  B) the port's kernel ``ops.conv_bn_relu.conv1x1_bn_relu`` (one launch).

Each side is timed with CUDA events after a warm-up. Prints one JSON line:
the shape, the kernel's largest error against its plain version (and the
library path's), both times and rates, and the bound of the work on an
H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s; NVIDIA data sheet) beside the
card's name and power limit.

    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.tools.conv_bn_experiment

It runs on ``cuda`` unless ``--device cpu`` is given; on the CPU both sides
are plain PyTorch and no time is reported (a CPU run times no device).
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..ops.conv_bn_relu import _conv1x1_bn_relu_ref, conv1x1_bn_relu
from ..utils.device import resolve_device

__all__ = ["run", "inputs", "tolerance", "bound", "library_path"]

DENSE_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def inputs(n: int, c: int, device) -> tuple:
    """x (n, c) bf16, w (c, c) bf16, a and b (c,) f32, drawn as the JAX
    tool draws them (``default_rng(0)``; the float64 draws rounded to bf16
    or f32 directly)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, c))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((c, c)) * 0.05).to(
        torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, (c,))).float()
    b = torch.from_numpy(rng.standard_normal((c,))).float()
    return tuple(t.to(device) for t in (x, w, a, b))


def tolerance(x, w, a, ref) -> torch.Tensor:
    """Elementwise error allowed between two computations of the function:
    one bf16 ulp of the reference (the final rounding of values that differ
    a little may go either way) plus ``K * 2^-24 * |a| * (|x| @ |w|)``, the
    worst-case error of an f32 sum of K products taken in another order."""
    k = x.shape[1]
    mag = torch.matmul(x.float().abs(), w.float().abs())
    return (ref.float().abs() * 2.0 ** -7
            + k * 2.0 ** -24 * a.abs() * mag)


def library_path(x, w, a, b) -> torch.Tensor:
    """Side A: cuBLAS bf16 ``torch.matmul``, then the epilogue in eager
    PyTorch."""
    return torch.relu(torch.matmul(x, w).float() * a + b).to(torch.bfloat16)


def bound(n: int, c_in: int, c_out: int) -> dict:
    """The least time an H100 SXM could take: 2 n c_in c_out FLOP at the
    dense bf16 rate against x, w, a, b read and y written once at the HBM
    rate; the larger bounds it."""
    flops = 2 * n * c_in * c_out
    nbytes = n * c_in * 2 + c_in * c_out * 2 + 2 * c_out * 4 + n * c_out * 2
    row = {"flop": flops, "bytes": nbytes,
           "ops_ms": flops / DENSE_BF16_FLOPS * 1e3,
           "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
    row["bound_by"] = ("operations" if row["ops_ms"] >= row["bytes_ms"]
                       else "bytes")
    return row


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _events_ms(fn, args, steps: int) -> float:
    fn(*args)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps


def run(b: int = 4, h: int = 155, w: int = 155, c: int = 720,
        tile_n: int = 512, steps: int = 50, device=None) -> dict:
    """Both sides at (b * h * w padded to tile_n, c) x (c, c); prints and
    returns the JSON row."""
    dev = resolve_device(device)
    n = b * h * w
    n_pad = (n + tile_n - 1) // tile_n * tile_n
    x, wt, a, bias = inputs(n_pad, c, dev)
    ref = _conv1x1_bn_relu_ref(x, wt, a, bias)
    y = conv1x1_bn_relu(x, wt, a, bias)
    ya = library_path(x, wt, a, bias)
    err = (y.float() - ref.float()).abs()
    row = {"shape": f"({n_pad},{c})x({c},{c})", "device": dev.type,
           "max_abs_err": float(err.max()),
           "within_tolerance": bool((err <= tolerance(x, wt, a, ref)).all()),
           "library_max_abs_err": float((ya.float() - ref.float()).abs()
                                        .max())}
    bnd = bound(n_pad, c, c)
    if dev.type == "cuda":
        t_lib = _events_ms(library_path, (x, wt, a, bias), steps)
        t_ker = _events_ms(conv1x1_bn_relu, (x, wt, a, bias), steps)
        row.update(library_ms=t_lib, kernel_ms=t_ker,
                   library_TFs=bnd["flop"] / t_lib / 1e9,
                   kernel_TFs=bnd["flop"] / t_ker / 1e9, card=_card())
    else:  # plain PyTorch on the CPU: no device was timed
        row.update(library_ms=None, kernel_ms=None, library_TFs=None,
                   kernel_TFs=None, card=None)
    row.update(bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args(argv)
    run(steps=args.steps, device=args.device)


if __name__ == "__main__":
    main()
