"""The BatchNorm kernels of this tree against those of another tree of the
port (an earlier commit's ``csrc/``), on the card, at every BN shape of the
W48, UNet and HRNet-W18 train steps and forwards.

Both trees' ``scale_bias_act.cu``, ``bn_stats.cu`` and ``bn_backward.cu``
are built with the same ``nvcc`` flags (the other tree's into
``build/other_kernels/``) and called through this tree's wrappers
(``ops/fused_bn_act.py``) on the same seeded inputs: the other tree's
C entries must take the same arguments, which holds for every tree whose
entries have this tree's signatures; an entry the other tree lacks (kernel
2's train entry, ``rhss_bn_act_forward``, before it came) is not compared.
A tree without that entry takes kernel 2's ``(C,)`` vectors tiled to the
view's width ``lcm(C, 8)``: its ``rhss_scale_bias_act`` is handed the
tiled copies, made once per shape before the timing (so its time is the
kernel's alone, without the two ``repeat`` launches its own wrapper made
per call). At each (shape, dtype, act) that a bf16 train-mode forward of
each model at batch 16 (W48 and W18 at 620 px, the UNet at 352 px;
``<model> step``) gives its BatchNorms, every output of kernel
2, kernel 1 and its sums entry, and kernel 3 and its reduce and dx
entries, and at each of a bf16 eval-mode forward at batch 4 (``<model>
forward``) every output of kernel 2, must be the same bits from both
builds. Each kernel's time is taken with CUDA events around a CUDA graph
of launches that take in turn copies of the inputs holding twice the L2
cache (so each reads from device memory, as ``chip_smoke.py`` times
them), in turns (this tree, the other, the other, this one), and summed
over the pass's calls. Prints one JSON line; exits 1 where a bit
differs.

    git archive <commit> restrictive_hierarchical_semantic_segmentation_tpu_torch/csrc \\
        | tar -x -C build/parent
    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.tools.kernel_bits_against \\
        --other build/parent/restrictive_hierarchical_semantic_segmentation_tpu_torch/csrc
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..config.hrnet import resolve_hrnet_config
from ..hierarchy.tree import ClassTree
from ..models import BatchNormAct, build_model
from ..ops import _build
from ..ops import fused_bn_act as fba

LIBS = ("scale_bias_act", "bn_stats", "bn_backward")
# model_select, name, size, HRNet config
MODELS = ((1, "W48", 620, None), (0, "UNet", 352, None),
          (1, "W18", 620, "w18"))
PASSES = (("step", 16, True), ("forward", 4, False))  # batch, train mode
EPS = 1e-5
L2_BYTES = 50 * 2 ** 20


def build_other(csrc: Path, out: Path) -> dict:
    """The other tree's libraries, built at once: {name: ctypes.CDLL}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in LIBS:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"lib{name}.so"), str(csrc / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{err}")
    return {name: ctypes.CDLL(str(out / f"lib{name}.so")) for name in LIBS}


class TiledVectors:
    """The ``rhss_scale_bias_act`` of a tree that takes scale and shift
    tiled to ``lcm(C, 8)``, called with this tree's arguments: the untiled
    vectors' addresses are swapped for those of their tiled copies, which
    :meth:`add` registers first."""

    def __init__(self, fn):
        self.fn = fn
        self.tiled = {}  # address of an untiled vector -> its tiled copy

    def add(self, vectors, c: int) -> None:
        for t in vectors:
            self.tiled[t.data_ptr()] = fba._tiled(t, c).contiguous()

    def __call__(self, x, scale, shift, y, rows, c, *rest):
        if fba._view_width(c) != c:
            scale, shift = (self.tiled[p].data_ptr() for p in (scale, shift))
        return self.fn(x, scale, shift, y, rows, c, *rest)


def other_fns(libs: dict) -> dict:
    """The other tree's entries with this tree's argument types (the ones
    it has); kernel 2's eval entry behind :class:`TiledVectors` where the
    tree has no train entry."""
    fns = {}
    for (lib, sym), argtypes in fba._SIGNATURES.items():
        if lib in libs and hasattr(libs[lib], sym):
            fn = getattr(libs[lib], sym)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            fns[(lib, sym)] = fn
    if not hasattr(libs["scale_bias_act"], "rhss_bn_act_forward"):
        key = ("scale_bias_act", "rhss_scale_bias_act")
        fns[key] = TiledVectors(fns[key])
    return fns


def bn_shapes(device) -> dict:
    """{"<donor> <pass>": {(NHWC shape, dtype, act): calls}} of one bf16
    forward of each of ``PASSES``."""
    tree = ClassTree.from_json("assets/class_tree_tl.json",
                               "assets/class_map.csv")
    out = {}
    for (ms, name, size, config), (kind, batch, train) in (
            (d, p) for d in MODELS for p in PASSES):
        model = build_model(tree, ms, 1,
                            config and resolve_hrnet_config(config)).to(
            device, memory_format=torch.channels_last).train(train)
        shapes = {}

        def record(mod, args):
            xn = args[0].permute(0, 2, 3, 1)
            key = (tuple(xn.shape), xn.dtype, mod.act)
            shapes[key] = shapes.get(key, 0) + 1

        hooks = [m.register_forward_pre_hook(record) for m in model.modules()
                 if isinstance(m, BatchNormAct)]
        x = torch.randn(batch, size, size, 3, device=device)
        with torch.no_grad(), torch.autocast("cuda", torch.bfloat16):
            model(x)
        for h in hooks:
            h.remove()
        out[f"{name} {kind}"] = shapes
        del model, x
        torch.cuda.empty_cache()
    return out


def calls(shape, dtype, act, gen, device, train: bool, tiled=None):
    """{kernel: a call of it on input set i} at one shape (every kernel of
    a train-mode BN, or kernel 2 alone), over seeded input sets that hold
    twice the L2 cache together; and the number of sets. ``tiled``: the
    other tree's :class:`TiledVectors`, given kernel 2's vectors."""
    c = shape[-1]
    x = (torch.randn(shape, generator=gen, device=device) * 1.5
         + 0.3).to(dtype)
    g = torch.randn(shape, generator=gen, device=device).to(dtype)
    gamma = torch.rand(c, generator=gen, device=device) + 0.5
    beta = torch.randn(c, generator=gen, device=device) * 0.5
    mean, var = fba._bn_stats_ref(x)
    rstd = torch.rsqrt(var + EPS)
    vecs = (gamma * rstd, beta - mean * gamma * rstd, mean, rstd)
    if tiled is not None:
        tiled.add(vecs[:2], c)
    bact = act if act in fba.TRAIN_ACTS else "none"
    sums = fba._bn_backward_reduce_ref(x.reshape(-1, c), g.reshape(-1, c),
                                       *vecs, bact)[2]
    n = max(2, -(-2 * L2_BYTES // (2 * x.numel() * x.element_size())))
    sets = [(x, g)] + [(x.clone(), g.clone()) for _ in range(n - 1)]
    out = {"scale_bias_act": lambda i: fba.fused_scale_bias_act(
        sets[i][0], vecs[0], vecs[1], act)}
    if train:
        out.update({
            "bn_stats": lambda i: fba.bn_stats(sets[i][0]),
            "bn_stats_sums": lambda i: fba.bn_stats_sums(sets[i][0]),
            "bn_backward": lambda i: fba.bn_act_backward(*sets[i], *vecs,
                                                         bact),
            "bn_backward_reduce": lambda i: fba.bn_backward_reduce(
                *sets[i], *vecs, bact),
            "bn_backward_dx": lambda i: fba.bn_backward_dx(
                *sets[i], *vecs, sums, bact)})
    return out, n


def outputs(result) -> list:
    items = result if isinstance(result, tuple) else (result,)
    return [t.clone() for t in items if t is not None]


def graph_ms(fn, sets: int, reps: int) -> float:
    """Device time of one call: ``max(reps, sets)`` calls ``fn(i)``, taking
    the input sets in turn, captured in a CUDA graph and replayed between
    CUDA events (the host's cost of a call left out)."""
    reps = max(reps, sets)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i % sets)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 5 / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="the other tree's csrc/ directory")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bits_against: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    _build.build(LIBS)
    mine = {key: fba._fn(*key) for key in fba._SIGNATURES if key[0] in LIBS}
    theirs = other_fns(build_other(Path(args.other),
                                   Path("build/other_kernels")))
    tiled = theirs[("scale_bias_act", "rhss_scale_bias_act")]
    tiled = tiled if isinstance(tiled, TiledVectors) else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device=device).manual_seed(0)
    report = {"card": card, "reps": args.reps, "paths": {}}
    same = True
    for path, shapes in bn_shapes(device).items():
        tot = {}
        for (shape, dtype, act), n in sorted(shapes.items(), key=str):
            fns, sets = calls(shape, dtype, act, gen, device,
                              path.endswith("step"), tiled)
            for name, fn in fns.items():
                row = tot.setdefault(name, {"calls": 0, "shapes": 0,
                                            "bits_equal": True, "ms": 0.0,
                                            "other_ms": 0.0})
                fba._FNS.update(mine)
                a = outputs(fn(0))
                t = [graph_ms(fn, sets, args.reps)]
                fba._FNS.update(theirs)
                b = outputs(fn(0))
                t += [graph_ms(fn, sets, args.reps),
                      graph_ms(fn, sets, args.reps)]
                fba._FNS.update(mine)
                t.append(graph_ms(fn, sets, args.reps))
                torch.cuda.synchronize()
                equal = len(a) == len(b) and all(
                    torch.equal(u, v) for u, v in zip(a, b))
                if not equal:
                    print(f"{path} {name} {shape} {dtype} {act}: the bits "
                          "differ", file=sys.stderr)
                row["bits_equal"] &= equal
                same &= equal
                row["calls"] += n
                row["shapes"] += 1
                row["ms"] += n * (t[0] + t[3]) / 2
                row["other_ms"] += n * (t[1] + t[2]) / 2
        for row in tot.values():
            row["ratio"] = row["ms"] / row["other_ms"]
        report["paths"][path] = tot
    report["bits_equal"] = same
    print(json.dumps(report), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    os.chdir(Path(__file__).resolve().parents[2])
    sys.exit(main())
