#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line of numbers each; any failed check raises and the exit code
is non-zero:

  1. device  — the CUDA device's name and nvidia-smi's name/power limit.
  2. build   — compiles the crms_grid CUDA kernel from the checkout's sources.
  3. kernel  — the kernel against its plain-torch version on numpy-seeded
               inputs at the main path's shape (72, 64) in per-app mode and a
               search-sized (20000, 64) in sum mode: rtol 1e-5 on lanes with
               rho <= 0.99, 1e-4 on all stable lanes (float32 with CUDA's
               expf/logf against torch's; near rho -> 1 the Erlang tail
               amplifies last-place differences), sentinel lanes > 1e6 in both.
               Times (CUDA events) of both and the lower bound from the shapes.
  4. main    — allocate("crms", ...) on the card for the paper's four apps
               (fitted) and make_tenant_mix(M), M in {8, 16, 32, 64}, against
               the JAX reference's results in tests/data/torch_port_golden.json:
               identical counts, utility within rtol 1e-6, equal refinement /
               accepted-move / P1-call counters, and at least one kernel launch
               per refinement iteration.
  5. vector  — crms_priority (a per-app alpha vector) at M=8, which evaluates
               the grid with the float64 oracle, so it launches no kernel.

The last three lines are nvidia-smi's "name, power.limit", a JSON object with
the kernel's numbers, and {"ok": true, "device": {...}}. Without a CUDA device
the script prints no result and exits non-zero.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_golden.json"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/crms_grid.cu"
REPLACES = "src/repro/kernels/crms_grid.py:86"
SEED = 0
KW = dict(caps_cpu=30.0, power_span=150.0, alpha=1.4, beta=0.2)

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside
# the tensor cores in operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# float32 operations per lane of the crms_grid function: per term of the
# Erlang head sum (log k!, term, mask, running max, two exps, rescaled sum)
# and once per lane (Eq. (1), mu, rho, Stirling, tail, Ws, utility).
OPS_PER_TERM = 14
OPS_PER_LANE = 40
MAX_N = 128


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def grid_inputs(B, M, seed, n_range=(3, 12)):
    """The kernel tests' input distribution; ``n_range`` bounds the counts
    (a wider range keeps whole 64-app rows stable for the sum mode)."""
    rng = np.random.default_rng(seed)
    kappa = np.stack(
        [rng.uniform(20, 120, M), rng.uniform(0.8, 2.5, M), rng.uniform(0.2, 0.5, M)], axis=1
    )
    lam = rng.uniform(4, 12, M)
    xbar = rng.uniform(4, 6, M)
    n = rng.integers(*n_range, (B, M)).astype(float)
    c = rng.uniform(0.5, 3.0, (B, M))
    m = rng.uniform(0.25, 0.5, (B, M))
    return kappa, lam, xbar, n, c, m


def grid_bound_ms(n, M, per_app):
    """Least time for the function on these inputs: each input read once and
    the output written once over the memory rate, against the float32
    operations these counts need (n-1 terms of the head sum per lane) over
    the float32 rate. Returns (ms, "bytes" | "operations")."""
    B = n.shape[0]
    n_bytes = 4 * (5 * M + 3 * B * M + (B * M if per_app else B))
    terms = np.minimum(n, MAX_N) - 1
    n_ops = float(OPS_PER_TERM * terms.sum() + OPS_PER_LANE * n.size)
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(B, M, reduce, reps, plain_reps, n_range=(3, 12)):
    """Kernel vs plain version on the card; returns the phase's numbers."""
    from repro_torch.kernels import crms_grid, ref

    arrays = grid_inputs(B, M, SEED + B, n_range)
    dev = [torch.as_tensor(a, dtype=torch.float32, device="cuda").contiguous() for a in arrays]
    per_app = reduce == "per_app"

    def kernel():
        return crms_grid.crms_grid_launch(*dev, per_app=per_app, **KW)

    def plain():
        return ref.crms_grid_plain(*dev, reduce=reduce, **KW)

    out, want = kernel(), plain()
    torch.cuda.synchronize()
    out, want = out.cpu().numpy(), want.cpu().numpy()
    kappa, lam, xbar, n, c, m = arrays
    d = kappa[:, 0] / (1.0 - np.exp(-kappa[:, 1] * c)) + np.exp(kappa[:, 2] / m)
    rho = lam / (n * 1000.0 / (xbar * d))
    rho = rho if per_app else rho.max(axis=1)
    stable = want < 1e8
    if not stable.any():
        raise AssertionError(f"crms_grid ({B},{M}) {reduce}: no stable lane to compare")
    tight = stable & (rho <= 0.99)
    np.testing.assert_allclose(out[tight], want[tight], rtol=1e-5)
    np.testing.assert_allclose(out[stable], want[stable], rtol=1e-4)
    if not (np.all(out[~stable] > 1e6) and np.all(want[~stable] > 1e6)):
        raise AssertionError("crms_grid: a sentinel lane is not > 1e6")
    if not np.all(np.isfinite(out)):
        raise AssertionError("crms_grid: non-finite output")
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps, warmup=1)
    bound, bound_by = grid_bound_ms(n, M, per_app)
    res = {
        "shape": f"({B},{M})", "reduce": reduce, "stable_lanes": int(stable.sum()),
        "sentinel_lanes": int((~stable).sum()),
        "max_abs_err": float(np.max(np.abs(out[stable] - want[stable]))),
        "max_rel_err": float(np.max(np.abs(out[stable] - want[stable]) / np.abs(want[stable]))),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
    }
    log("kernel", **res)
    return res


def build_instance(spec, device):
    from repro_torch.core.problem import ServerCaps
    from repro_torch.core.profiler import make_paper_apps, make_tenant_mix

    if spec["builder"] == "make_tenant_mix":
        apps, caps, _ = make_tenant_mix(spec["M"])
        return apps, caps
    apps = make_paper_apps(lam=spec["lam"], fitted=spec["fitted"], device=device)
    return apps, ServerCaps(*spec["caps"])


def run_entry(name, golden, device):
    """One allocate() on the card against the golden entry; returns the
    kernel launches it made."""
    from repro_torch.api import AllocRequest, allocate
    from repro_torch.kernels import crms_grid

    entry = golden["entries"][name]
    apps, caps = build_instance(golden["instances"][entry["instance"]], device)
    before = crms_grid.launches
    t0 = time.perf_counter()
    res = allocate(entry["policy"], AllocRequest(apps, caps, extra=entry["extra"],
                                                 device=device))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = crms_grid.launches - before
    alloc, diag = res.allocation, res.diagnostics
    if list(map(int, alloc.n)) != entry["n"]:
        raise AssertionError(f"{name}: counts {alloc.n.tolist()} != reference {entry['n']}")
    if not abs(alloc.utility - entry["utility"]) <= 1e-6 * abs(entry["utility"]):
        raise AssertionError(f"{name}: utility {alloc.utility!r} != reference {entry['utility']!r}")
    for k in ("refine_iters", "accepted_moves", "p1_calls"):
        if getattr(diag, k) != entry[k]:
            raise AssertionError(f"{name}: {k} {getattr(diag, k)} != reference {entry[k]}")
    if not (res.feasible and res.stable and np.all(np.isfinite(alloc.ws))):
        raise AssertionError(f"{name}: infeasible, unstable or non-finite result")
    quota_err = max(
        float(np.max(np.abs(alloc.r_cpu - entry["r_cpu"]) / np.abs(entry["r_cpu"]))),
        float(np.max(np.abs(alloc.r_mem - entry["r_mem"]) / np.abs(entry["r_mem"]))),
    )
    log("main", case=name, policy=entry["policy"], M=len(apps), wall_s=wall,
        utility=alloc.utility, utility_rel_err=abs(alloc.utility - entry["utility"])
        / abs(entry["utility"]), quota_rel_err=quota_err, refine_iters=diag.refine_iters,
        accepted_moves=diag.accepted_moves, p1_calls=diag.p1_calls, launches=launches,
        p1_rescued_rows=diag.p1_rescued_rows, ref_p1_rescued_rows=entry["p1_rescued_rows"],
        p1_masked_rows=diag.p1_masked_rows, ref_p1_masked_rows=entry["p1_masked_rows"])
    return launches, diag.refine_iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import crms_grid

    golden = json.loads(GOLDEN.read_text())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    built = crms_grid.build(force=True)
    log("build", seconds=built["seconds"], library=built["library"])
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print("[build] ptxas:", line.strip(), flush=True)

    # 3. kernel against its plain version
    path_shape = check_kernel(72, 64, "per_app", reps=2000, plain_reps=20)
    check_kernel(20000, 64, "sum", reps=200, plain_reps=5, n_range=(8, 20))
    log("kernel", library_equivalent="none (no single PyTorch call computes Erlang-C Ws)")

    # 4. the main path, counted from zero
    crms_grid.launches = 0
    for entry in ("paper_fitted", "mix8", "mix16", "mix32", "mix64"):
        launches, refine_iters = run_entry(entry, golden, "cuda")
        if launches < refine_iters:
            raise AssertionError(f"{entry}: {launches} crms_grid launches < "
                                 f"{refine_iters} refinement iterations")
    main_launches = crms_grid.launches
    log("main", crms_grid_launches=main_launches)
    if main_launches == 0:
        raise AssertionError("the main path never launched the crms_grid kernel")

    # 5. vector alpha: the float64 oracle branch, no kernel launch
    launches, _ = run_entry("priority_mix8", golden, "cuda")
    if launches != 0:
        raise AssertionError(f"crms_priority launched the scalar-alpha kernel {launches} times")

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "crms_grid", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": main_launches, "max_abs_err": path_shape["max_abs_err"],
        "ms": path_shape["ms"], "plain_ms": path_shape["plain_ms"],
        "bound_ms": path_shape["bound_ms"], "bound_by": path_shape["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
