"""CRMS allocating the modelled 256-chip TPU v5e pod across the ten assigned
architectures (chips/replica, HBM/replica, replica count) against the search
baselines: the port's mirror of ``benchmarks/fleet_tpu.py``.

    PYTHONPATH=src python benchmarks_torch/fleet_tpu.py [--device cpu] [--out FILE]

Fits Eq. (1) to the analytic workloads (``core/fleet.default_workloads``)
on the device, then runs ``crms``, ``random_search`` (20000 samples, seed 0)
and ``tpebo`` (seed 0) on the pod's caps, prints the reference's table and
comparison, and writes ``bench_torch/fleet_tpu.json`` (or ``--out``): the
three allocations, their λ-weighted mean latencies and wall clocks, and
``ok`` — CRMS feasible, stable and no slower on mean latency than either
baseline, the reference's check. Runs on the CUDA device unless ``--device``
names another. The pod's figures are the modelled TPU's latency-model
inputs (``core/fleet``), not a measurement of the device this runs on.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ALPHA, BETA = 1.4, 0.2  # paper §VI
N_CHIPS = 256
RS_SAMPLES = 20000


def mean_latency(apps, record) -> float:
    """λ-weighted mean response [s] of an allocation record (inf unless every
    app is stable with a finite Ws), as benchmarks/common.py's mean_latency."""
    ws = record["ws"]
    if not record["stable"] or any(w is None or not np.isfinite(w) for w in ws):
        return float("inf")
    lam = np.array([a.lam for a in apps])
    return float(np.sum(lam * np.asarray(ws)) / np.sum(lam))


def record(alloc) -> dict:
    """An allocation as JSON-safe lists (non-finite floats as None)."""
    def num(x):
        x = float(x)
        return x if np.isfinite(x) else None

    return {"n": [int(v) for v in alloc.n], "r_cpu": [num(v) for v in alloc.r_cpu],
            "r_mem": [num(v) for v in alloc.r_mem], "ws": [num(v) for v in alloc.ws],
            "utility": num(alloc.utility), "feasible": bool(alloc.feasible),
            "stable": bool(alloc.stable)}


def compare(apps, caps, device=None):
    """The benchmark's three solves on ``apps`` on ``device``: ({policy:
    record}, {policy: wall clock s})."""
    from repro_torch.core.baselines import random_search, tpebo
    from repro_torch.core.crms import crms

    calls = {"crms": lambda: crms(apps, caps, ALPHA, BETA, device=device),
             "random_search": lambda: random_search(apps, caps, ALPHA, BETA,
                                                    n_samples=RS_SAMPLES, seed=0, device=device),
             "tpebo": lambda: tpebo(apps, caps, ALPHA, BETA, seed=0, device=device)}
    on_card = torch.cuda.is_available() and device != "cpu"
    records, walls = {}, {}
    for name, call in calls.items():
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        records[name] = record(call())
        if on_card:
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    return records, walls


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--out", default=str(ROOT / "bench_torch" / "fleet_tpu.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.fleet import build_fleet_apps, default_workloads, pod_caps
    from repro_torch.device import resolve_device

    device = str(resolve_device(args.device))
    apps = build_fleet_apps(default_workloads(), seed=0, device=device)
    caps = pod_caps(N_CHIPS)
    records, walls = compare(apps, caps, device=device)

    alloc = records["crms"]
    print(f"\nTPU fleet allocation ({N_CHIPS} chips, {caps.r_mem:.0f} GB HBM) — CRMS")
    print(f"{'arch':26s} {'lam':>5s} {'N':>3s} {'chips':>7s} {'HBM GB':>8s} {'Ws ms':>9s}")
    for i, app in enumerate(apps):
        print(f"{app.name:26s} {app.lam:5.1f} {alloc['n'][i]:3d} {alloc['r_cpu'][i]:7.1f} "
              f"{alloc['r_mem'][i]:8.1f} {alloc['ws'][i]*1e3:9.2f}")
    n = np.asarray(alloc["n"])
    print(f"chips used {np.sum(n * alloc['r_cpu']):.0f}/{N_CHIPS}, "
          f"HBM {np.sum(n * alloc['r_mem']):.0f}/{caps.r_mem:.0f} GB, "
          f"U={alloc['utility']:.3f} feasible={alloc['feasible']} stable={alloc['stable']}")

    latency = {name: mean_latency(apps, r) for name, r in records.items()}
    w_crms, w_rs, w_tp = latency["crms"], latency["random_search"], latency["tpebo"]
    red_rs = 100 * (1 - w_crms / w_rs) if np.isfinite(w_rs) else 100.0
    red_tp = 100 * (1 - w_crms / w_tp) if np.isfinite(w_tp) else 100.0
    print(f"mean latency: CRMS {w_crms*1e3:.2f}ms vs RS {w_rs*1e3:.2f}ms ({red_rs:.0f}% lower) "
          f"vs TPEBO {w_tp*1e3:.2f}ms ({red_tp:.0f}% lower)")
    ok = alloc["feasible"] and alloc["stable"] and w_crms <= min(w_rs, w_tp)

    doc = {"device": device, "device_name": (torch.cuda.get_device_name(0)
                                             if device.startswith("cuda") else "cpu"),
           "n_chips": N_CHIPS, "alpha": ALPHA, "beta": BETA, "rs_samples": RS_SAMPLES,
           "apps": [a.name for a in apps], "records": records,
           "mean_latency_s": {k: (v if np.isfinite(v) else None) for k, v in latency.items()},
           "reduction_pct": {"random_search": red_rs, "tpebo": red_tp},
           "wall_s": walls, "ok": bool(ok)}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {out}; ok={ok}")
    return doc


if __name__ == "__main__":
    sys.exit(0 if run()["ok"] else 1)
