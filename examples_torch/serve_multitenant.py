"""Multi-tenant serving with CRMS as the fleet allocator, as
``examples/serve_multitenant.py`` runs it on the reference.

1. FleetManager fits Eq.(1) latency surfaces for all ten architectures from
   the pod's roofline model and runs CRMS over the 256-chip pod.
2. Arrival rates drift; the quasi-dynamic allocator re-plans only past the
   drift threshold (paper §V-B).
3. Two reduced-config tenants actually serve batched requests through the
   Engine, with batch slots taken from their HBM grants.

Run:  PYTHONPATH=src python examples_torch/serve_multitenant.py [--device cpu]

The fit, the solves and the tenants run on the CUDA device unless
``--device`` names another (a RuntimeError without a card). Each tenant's
weights come from a ``torch.Generator`` seeded with ``SEED`` plus the
tenant's index; the reference seeds ``jax.random.PRNGKey(hash(arch) %
2**31)``, which changes with ``PYTHONHASHSEED``, so the served tokens are
not compared with the reference's. ``main`` returns the printed values as a
dict.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.layers import Runtime
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.fleet import FleetManager

SEED = 0
TENANTS = ("gemma-2b", "codeqwen1.5-7b")
DRIFT = ((1.03, "small (no re-opt)"), (1.6, "large (re-opt)"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    device = ap.parse_args(argv).device

    # ---- 1. pod-level plan -------------------------------------------------
    fm = FleetManager(n_chips=256, device=device)
    alloc, groups = fm.plan()
    print(f"CRMS pod plan: U={alloc.utility:.3f} chips={alloc.total_cpu():.0f}/256 "
          f"HBM={alloc.total_mem():.0f}/4096GB replicas={len(groups)}")
    for i, app in enumerate(fm.apps):
        print(f"  {app.name:26s} N={alloc.n[i]:2d} chips/replica={alloc.r_cpu[i]:6.1f} "
              f"HBM/replica={alloc.r_mem[i]:7.1f}GB Ws={alloc.ws[i]*1e3:8.2f}ms")

    # ---- 2. quasi-dynamic re-planning under drift ---------------------------
    print("\narrival-rate drift:")
    reoptimized = []
    for scale, label in DRIFT:
        fm.observe({a.name: a.lam * scale for a in fm.apps})
        before = fm.allocator.reoptimizations
        fm.plan()
        reoptimized.append(fm.allocator.reoptimizations > before)
        print(f"  drift x{scale}: re-optimized={reoptimized[-1]}  ({label})")

    # ---- 3. two tenants actually serve --------------------------------------
    print("\nserving demo (reduced configs):")
    rt = Runtime(device=device, compute_dtype=torch.float32)
    served = {}
    for k, arch in enumerate(TENANTS):
        cfg = get_config(arch).reduced()
        lm = init_params(cfg, torch.Generator(device=rt.device).manual_seed(SEED + k),
                         device=rt.device)
        eng = Engine(cfg, lm, rt, slots=2, max_len=48)
        for rid in range(3):
            eng.submit(Request(rid=rid, prompt=np.arange(1, 9, dtype=np.int32), max_new=6))
        done = eng.run()
        served[arch] = {r.rid: [int(t) for t in r.out] for r in done}
        print(f"  {arch:16s} served {len(done)} requests: " +
              "; ".join(str(r.out) for r in done))
    return {"fleet": fm, "alloc": alloc, "groups": groups, "reoptimized": reoptimized,
            "served": served}


if __name__ == "__main__":
    main()
