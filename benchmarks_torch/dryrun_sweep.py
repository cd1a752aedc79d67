"""The dry-run's whole sweep (``repro_torch.launch.dryrun``, every arch x
shape x mesh cell) in parallel: each cell is one run of the dry-run's CLI in
a process of its own, ``--jobs`` at a time (each trace is single-threaded
host code), the longest cells (train, by depth x microbatches) first. The
rows are merged into one JSON file in the CLI's order, and a summary line
gives the cell count, ok / skip / fail, the sum of the cells' trace seconds,
the slowest cell and the wall clock. Exits 1 on any failed cell, as the
CLI does.

    PYTHONPATH=src python benchmarks_torch/dryrun_sweep.py [--device cuda|cpu]
        [--jobs N] [--arch all] [--shape all] [--mesh both] [--out FILE]

``--device cuda`` (the default) needs the card's host (the fake CUDA mesh
takes card 0); ``cpu`` runs anywhere.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def cells(archs, shapes, meshes):
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def cost(cell) -> int:
    """A rank of a cell's trace time: a train cell traces its depth at one
    microbatch and again at the production microbatches."""
    from repro_torch.configs import SHAPES, get_config

    arch, shape, _ = cell
    cfg = get_config(arch)
    kind = SHAPES[shape][2]
    return cfg.n_layers * ((1 + cfg.microbatches) * 3 if kind == "train" else 1)


def run_one(cell, device, tmp):
    arch, shape, mesh = cell
    out = Path(tmp) / f"{arch}_{shape}_{mesh}.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                           "--shape", shape, "--mesh", mesh, "--device", device, "--out",
                           str(out)], env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if out.exists():
        [row] = json.loads(out.read_text())
    else:  # the process died before it wrote its row
        row = {"arch": arch, "shape": shape, "mesh": mesh,
               "status": f"FAIL: the process exited {proc.returncode}",
               "traceback": proc.stderr[-4000:]}
    row["process_s"] = wall
    print(f"[{row['status'][:40]}] {arch} {shape} {mesh}: trace {row.get('lower_s')} s, "
          f"process {wall:.1f} s", flush=True)
    return row


def main(argv=None):
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=os.cpu_count())
    ap.add_argument("--out", default=str(ROOT / "bench_torch" / "dryrun.json"))
    args = ap.parse_args(argv)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]
    todo = cells(archs, shapes, meshes)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(args.jobs) as pool:
        futures = {c: pool.submit(run_one, c, args.device, tmp)
                   for c in sorted(todo, key=cost, reverse=True)}
        rows = [futures[c].result() for c in todo]
    wall = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    ok = [r for r in rows if r.get("status") == "ok"]
    skip = [r for r in rows if str(r.get("status", "")).startswith("SKIP")]
    fail = [r for r in rows if r not in ok and r not in skip]
    slowest = max(ok, key=lambda r: r["lower_s"], default=None)
    summary = {"cells": len(rows), "ok": len(ok), "skip": len(skip), "fail": len(fail),
               "failed": [f"{r['arch']} {r['shape']} {r['mesh']}: {r['status']}" for r in fail],
               "trace_s_sum": sum(r["lower_s"] for r in ok),
               "slowest": slowest and {k: slowest[k] for k in ("arch", "shape", "mesh",
                                                                 "lower_s", "process_s")},
               "process_s_sum": sum(r["process_s"] for r in rows), "jobs": args.jobs,
               "wall_s": wall, "device": args.device, "out": args.out}
    print(json.dumps(summary), flush=True)
    return 0 if not fail else 1


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    raise SystemExit(main())
