"""Serving launcher of the port: CRMS fleet plan + a local engine demo.

    python -m repro_torch.launch.serve [--plan] [--chips 256] [--device cpu]
    python -m repro_torch.launch.serve --demo [--device cpu]

``--plan`` (the default without ``--demo``) prints the CRMS allocation for
the ten-architecture fleet on a pod of ``--chips`` chips, as ``python -m
repro.launch.serve --plan`` does on the reference. ``--demo`` runs the
reduced gemma-2b (random weights from a seeded generator) through the
``Engine``. Both run on the CUDA device unless ``--device`` names another.
``main`` returns the plan's ``FleetManager``, allocation and replica groups
(None without a plan).
"""
import argparse

import numpy as np
import torch

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plan", action="store_true", help="print the CRMS fleet plan (default)")
    ap.add_argument("--demo", action="store_true", help="run the reduced gemma-2b engine demo")
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    plan = None
    if args.plan or not args.demo:
        from repro_torch.serve.fleet import FleetManager

        fm = FleetManager(n_chips=args.chips, device=args.device)
        alloc, groups = fm.plan()
        print(f"fleet utility: {alloc.utility:.3f} feasible={alloc.feasible} stable={alloc.stable}")
        print(f"{'arch':28s} {'N':>3s} {'chips':>7s} {'HBM GB':>8s} {'Ws ms':>8s}")
        for i, app in enumerate(fm.apps):
            print(
                f"{app.name:28s} {alloc.n[i]:3d} {alloc.r_cpu[i]:7.1f} "
                f"{alloc.r_mem[i]:8.1f} {alloc.ws[i]*1e3:8.1f}"
            )
        print(f"replica groups: {len(groups)}; chips used {alloc.total_cpu():.0f}/{args.chips}")
        plan = fm, alloc, groups

    if args.demo:
        from repro_torch.configs import get_config
        from repro_torch.device import resolve_device
        from repro_torch.models.layers import Runtime
        from repro_torch.models.model import init_params
        from repro_torch.serve.engine import Engine, Request

        device = resolve_device(args.device)
        cfg = get_config("gemma-2b").reduced()
        lm = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
        eng = Engine(cfg, lm, Runtime(device=device, compute_dtype=torch.float32),
                     slots=2, max_len=64)
        for rid in range(4):
            eng.submit(Request(rid=rid, prompt=np.arange(1, 9, dtype=np.int32), max_new=8))
        for r in eng.run():
            print(f"req {r.rid}: {r.out}")
    return plan


if __name__ == "__main__":
    main()
