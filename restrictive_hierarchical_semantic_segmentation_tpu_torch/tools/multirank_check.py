"""Multi-rank check of the train CLI: N processes, one rank and one card
each, against one process, on the same data and seed (counterpart of the
JAX package's ``tools/multihost_trainer_check.py``).

Two runs (``--runs``: both by default), each compared with the same CLI
in one process:

1. **data axis**: one fold trained by N ranks (``--dist-coordinator
   127.0.0.1:<free port> --dist-procs N --dist-proc-id i``; rank i on
   ``cuda:i``, NCCL, or gloo with ``--device cpu``), each loading its rows
   of every batch, BatchNorm over the whole batch;
2. **fold-parallel**: two folds with ``--fold-parallel True`` over the same
   N ranks (a ``(fold=2, data=N/2)`` mesh: each fold trained by its group).

``--n-space K`` runs each with ``--n-space K``: the ranks' mesh gets a
``space`` axis of K, each rank holding a band of the rows of every image
(``parallel/bands.py``; the fold-parallel mesh is then ``make_fold_mesh``'s
``(fold, data, space)``). With fewer cards than ranks the ranks share
the cards (rank i on ``cuda:{i % cards}``) over gloo, which the CLI's
``init_distributed`` takes itself there (NCCL refuses two ranks on one
device).

The recipe is the JAX train CLI's defaults with bf16 compute and
``--learning-rate "[1e-6]"``: with updates of about 1e-6 the two sides'
trajectories cannot separate in two epochs, so every epoch's values are
held (the JAX tool's contraction regime): train and validation loss
within rtol ``LOSS_RTOL``, the selection metric (a Dice of argmax counts,
where a near-tied pixel of a barely trained net may flip) within
``MEASURE_ATOL``. The best checkpoints' epochs are reported: the metric
barely moves between epochs at this rate, so the strict-improvement gate
may go either way. At a trained learning rate AdamW's sign-like first
update turns sums in another order into whole-lr differences, so values
drift apart from the second step on (``chip_smoke.py`` phase 19 holds that
regime step by step).

Prints one JSON line with each run's wall time and epoch 2's seconds (the
trainer's host clock) beside the single process's; ranks sharing a card
are no scaling number, so there the single process runs beside them
rather than first. Exits non-zero if a check fails.

    python -m restrictive_hierarchical_semantic_segmentation_tpu_torch.tools.multirank_check \\
        --ranks 4                       # four cards
    python -m ...tools.multirank_check --ranks 4 --device cpu --img-size 32
    python -m ...tools.multirank_check --ranks 2 --n-space 2
                                        # on one card: two ranks share it
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI = "restrictive_hierarchical_semantic_segmentation_tpu_torch.cli.train"
LOSS_RTOL = 1e-3
MEASURE_ATOL = 5e-3  # tests/test_torch_trainer_jax.py's metric tolerance
# the columns held: train loss, val loss, the selection metric
COLUMNS = ("Train Loss", "Val Loss", "Val Test Measure Mean")
# each run: its folds and its flags beyond the recipe
RUNS = {"data_axis": (1, ()),
        "fold_parallel": (2, ("--fold-parallel", "True"))}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_argv(args, data: str, save: str, folds: int, extra: tuple,
               coordinator: str, rank: int) -> list:
    """Rank ``rank``'s command: the CLI with its ``--dist-*`` flags."""
    return _argv(args, data, save, folds, extra) + [
        "--dist-coordinator", coordinator, "--dist-procs", str(args.ranks),
        "--dist-proc-id", str(rank)]


def _argv(args, data: str, save: str, folds: int, extra=()) -> list:
    return [sys.executable, "-m", CLI, "--save-path", save,
            "--data-root", data,
            "--tree-root", os.path.join(REPO, "assets/class_tree_tl.json"),
            "--class-map", os.path.join(REPO, "assets/class_map.csv"),
            "--model-type", "1", "--img-size", str(args.img_size),
            "--compute-dtype", "bfloat16", "--learning-rate", "[1e-6]",
            "--epochs", str(args.epochs), "--folds", str(folds),
            "--device", args.device, *extra]


def _run(cmds: list, timeout: float) -> list:
    """Run the commands at once; return each one's wall seconds; raise if
    one fails or outlives ``timeout``; every process is ended before this
    returns."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs, walls = [""] * len(procs), [0.0] * len(procs)

    def wait(i: int) -> None:
        try:
            outs[i] = procs[i].communicate(timeout=timeout)[0]
        except subprocess.TimeoutExpired:
            outs[i] = f"outlived {timeout} s"
        walls[i] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=(i,))
             for i in range(len(procs))]
    try:
        for w in waits:
            w.start()
        for w in waits:
            w.join()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"exit codes {codes}:\n" + "\n".join(
            o[-3000:] for o in outs))
    return walls


def _rows(fold_dir: str) -> list:
    with open(os.path.join(fold_dir, "metrics.csv"), newline="") as f:
        rows = list(csv.reader(f))
    col = [rows[0].index(c) for c in COLUMNS]
    return [[float(r[i]) for i in col] for r in rows[1:]]


def _epoch_s(fold_dir: str) -> dict:
    with open(os.path.join(fold_dir, "logs", "metrics.jsonl")) as f:
        return {r["step"]: r["train/sec_per_epoch"]
                for r in map(json.loads, f) if "train/sec_per_epoch" in r}


def _best_last(fold_dir: str) -> list:
    out = []
    for name in ("best.ckpt", "last.ckpt"):
        with open(os.path.join(fold_dir, name, "rhss_meta.json")) as f:
            out.append(int(json.load(f)["epoch"]))
    return out


def _compare(one: str, many: str, folds) -> dict:
    """Each fold's rows of the N-rank run against the single process's;
    returns the largest loss difference (relative), the largest metric
    difference and both runs' best/last checkpoint epochs."""
    out = {"loss_max_rel": 0.0, "measure_max_abs": 0.0, "best_last": {}}
    for k in folds:
        a, b = (os.path.join(d, f"fold_{k}") for d in (one, many))
        ra, rb = _rows(a), _rows(b)
        if len(ra) != len(rb):
            raise AssertionError(f"fold {k}: {len(rb)} rows, want {len(ra)}")
        for ea, eb in zip(ra, rb):
            rel = max(abs(x - y) / abs(x) for x, y in zip(ea[:2], eb[:2]))
            diff = abs(ea[2] - eb[2])
            out["loss_max_rel"] = max(out["loss_max_rel"], rel)
            out["measure_max_abs"] = max(out["measure_max_abs"], diff)
            if rel > LOSS_RTOL or diff > MEASURE_ATOL:
                raise AssertionError(f"fold {k}: {eb} against {ea}")
        out["best_last"][k] = {"one": _best_last(a), "ranks": _best_last(b)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--img-size", type=int, default=352)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--images", type=int, default=64,
                   help="training images per fold (n // 4 more validate)")
    p.add_argument("--out", default=os.path.join(REPO, "build",
                                                 "multirank_check"))
    p.add_argument("--timeout", type=float, default=600)
    p.add_argument("--n-space", type=int, default=1,
                   help="the space axis of the ranks' mesh (every run)")
    p.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS),
                   help="the runs to check (default: both)")
    args = p.parse_args(argv)
    if args.ranks < 2 or args.ranks % 2:
        p.error("--ranks: an even number of at least 2 (two folds share "
                "them in the fold-parallel run)")
    if args.ranks % args.n_space:
        p.error("--n-space must divide --ranks")
    share = False
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("multirank_check: torch sees no CUDA device",
                  file=sys.stderr)
            return 2
        share = torch.cuda.device_count() < args.ranks  # over gloo
    sys.path.insert(0, REPO)
    from restrictive_hierarchical_semantic_segmentation_tpu_torch.data \
        .synthetic import write_synth_dataset

    shutil.rmtree(args.out, ignore_errors=True)
    result = {"ranks": args.ranks, "device": args.device,
              "n_space": args.n_space, "cards_shared": share}
    space = ("--n-space", str(args.n_space))
    for name in args.runs:
        folds, extra = RUNS[name]
        data = os.path.join(args.out, name, "data")
        write_synth_dataset(data, args.images, size=max(96, args.img_size),
                            seed=7, folds=folds)
        one = os.path.join(args.out, name, "one")
        many = os.path.join(args.out, name, "ranks")
        coordinator = f"127.0.0.1:{_free_port()}"
        ref = _argv(args, data, one, folds, extra)
        ranks = [_rank_argv(args, data, many, folds, (*extra, *space),
                            coordinator, i) for i in range(args.ranks)]
        if share:  # no scaling number either way: the reference beside
            walls = _run([ref] + ranks, args.timeout)
        else:
            walls = _run([ref], args.timeout) + _run(ranks, args.timeout)
        wall_one, wall_many = walls[0], max(walls[1:])
        res = _compare(one, many, range(1, folds + 1))
        res.update(wall_s_one=wall_one, wall_s_ranks=wall_many,
                   epoch2_s_one=_epoch_s(os.path.join(one, "fold_1")).get(2),
                   epoch2_s_ranks=_epoch_s(
                       os.path.join(many, "fold_1")).get(2))
        result[name] = res
    result["ok"] = True
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
