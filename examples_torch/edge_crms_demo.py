"""The paper's edge scenario replayed through the discrete-event simulator
with a time-varying workload, as ``examples/edge_crms_demo.py`` runs it on
the reference: the quasi-dynamic driver re-optimizes only when the monitor
reports material λ drift (§V-B), and the simulated response times track the
analytic model.

Uses the public allocation API: ``QuasiDynamicPolicy`` is the caching/
threshold decorator over the registered ``crms`` policy (it would wrap any
other registered policy the same way).

Run:  PYTHONPATH=src python examples_torch/edge_crms_demo.py [--device cpu]

The fit and the solves run on the CUDA device unless ``--device`` names
another (a RuntimeError without a card); the event simulator is host code,
as in the reference. ``main`` returns the printed values as a dict.
"""
import argparse

import numpy as np

from repro_torch.api import AllocRequest, QuasiDynamicPolicy, SolverOptions
from repro_torch.core.des import WorkloadPhase, run_quasi_dynamic
from repro_torch.core.problem import ServerCaps
from repro_torch.core.profiler import make_paper_apps

PHASES = [
    WorkloadPhase(0.0, (6, 6, 6, 6)),        # steady
    WorkloadPhase(600.0, (6.3, 5.9, 6.1, 6.2)),  # jitter below threshold
    WorkloadPhase(1200.0, (9, 8, 11, 13)),   # evening surge -> re-optimize
    WorkloadPhase(1800.0, (4, 4, 5, 6)),     # night lull -> re-optimize
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    device = ap.parse_args(argv).device

    apps = make_paper_apps(fitted=True, seed=0, device=device)
    caps = ServerCaps(r_cpu=32.0, r_mem=10.5)
    options = SolverOptions(qd_threshold=0.15)
    qd = QuasiDynamicPolicy("crms", threshold=options.qd_threshold)

    def allocator(phase_apps):
        request = AllocRequest(apps=phase_apps, caps=caps, alpha=1.4, beta=0.2,
                               options=options, device=device)
        return qd.allocate(request).allocation

    results = run_quasi_dynamic(apps, PHASES, allocator, phase_len=400.0, seed=0)

    print(f"{'t':>6s} {'lam':>22s} {'containers':>14s} {'mean response (s) per app':>34s}")
    for r in results:
        print(f"{r['t']:6.0f} {str(r['lam']):>22s} {str(r['alloc_n']):>14s} "
              f"{np.round(r['mean_response'], 3)}")
    print(f"\nre-optimizations: {qd.reoptimizations} of {len(PHASES)} phases "
          f"(threshold filters the jitter phase)")
    return {
        "phases": [{key: r[key] for key in ("t", "lam", "alloc_n", "mean_response")}
                   for r in results],
        "reoptimizations": qd.reoptimizations,
    }


if __name__ == "__main__":
    main()
