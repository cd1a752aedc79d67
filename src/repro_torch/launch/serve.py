"""Serving launcher of the port: a local engine demo.

    python -m repro_torch.launch.serve --demo [--device cpu]

runs the reduced gemma-2b (random weights from a seeded generator) through
the ``Engine`` on the CUDA device unless ``--device`` names another, as
``python -m repro.launch.serve --demo`` does on the reference. The
reference's ``--plan`` (the CRMS fleet plan) needs ``core/fleet`` and
``serve/fleet``, which are not ported yet (ROADMAP).
"""
import argparse

import numpy as np
import torch

SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true", help="run the reduced gemma-2b engine demo")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if not args.demo:
        ap.error("only --demo is ported; the fleet plan (--plan) waits for core/fleet (ROADMAP)")

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


if __name__ == "__main__":
    main()
