"""Where the time of one ``allocate("crms", ...)`` goes on the GPU.

    PYTHONPATH=src python benchmarks_torch/profile_crms.py --M 64

For make_tenant_mix(M) on the CUDA device, after one warm-up solve:

  1. a stage breakdown: host wall time of the solver stages (Algorithm 1, the
     NumPy phase-1 start, the grid-seeding sweep, the batched interior point,
     candidate scoring), each closed by torch.cuda.synchronize() so device
     work is charged to the stage that queued it;
  2. a torch.profiler trace of one more solve (no synchronizing wrappers):
     device busy time (sum of kernel times), the device's idle share of the
     wall time, kernel launches, and the kernels with the most device time.

Prints one JSON object (and writes it to ``--out`` when given). Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import AllocRequest, allocate  # noqa: E402
from repro_torch.core import crms as crms_mod  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.profiler import make_tenant_mix  # noqa: E402
from repro_torch.kernels import crms_grid  # noqa: E402

STAGES = [
    (crms_mod, "ideal_configs_batch", "algorithm1"),
    (engine, "find_feasible_start_batch", "phase1_start"),
    (engine, "grid_seed_chints", "grid_seed"),
    (engine, "_ip_solve_batched", "interior_point"),
    (crms_mod, "evaluate_candidates", "score_candidates"),
    (crms_mod, "evaluate", "evaluate"),
]


def _timed(fn, totals, counts, stage):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[stage] += time.perf_counter() - t0
        counts[stage] += 1
        return out

    return wrapper


def stage_breakdown(request):
    totals, counts = collections.defaultdict(float), collections.defaultdict(int)
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in STAGES]
    try:
        for mod, attr, stage in STAGES:
            setattr(mod, attr, _timed(getattr(mod, attr), totals, counts, stage))
        t0 = time.perf_counter()
        res = allocate("crms", request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    # grid seeding and phase 1 run inside p1_solve_batch, the interior point
    # after them; the stages do not nest otherwise
    return {"wall_s": wall, "refine_iters": res.diagnostics.refine_iters,
            "stages_s": dict(totals), "stage_calls": dict(counts),
            "unattributed_s": wall - sum(totals.values())}


def device_profile(request, top: int):
    from torch.profiler import ProfilerActivity, profile

    launches0 = crms_grid.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        allocate("crms", request)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    grid_ms = sum(v[0] for k, v in by_name.items() if "crms_grid" in k)
    return {
        "wall_s": wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
        "device_kernels": len(kernels), "crms_grid_launches": crms_grid.launches - launches0,
        "crms_grid_device_ms": grid_ms,
        "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in ranked[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--M", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_crms: needs a CUDA device", file=sys.stderr)
        return 1
    apps, caps, _ = make_tenant_mix(args.M)
    request = AllocRequest(apps, caps, device="cuda")
    t0 = time.perf_counter()
    allocate("crms", request)  # warm-up: CUDA context, kernel build, allocator
    torch.cuda.synchronize()
    out = {
        "device": torch.cuda.get_device_name(0), "M": args.M,
        "warmup_wall_s": time.perf_counter() - t0,
        "stages": stage_breakdown(request),
        "profile": device_profile(request, args.top),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
