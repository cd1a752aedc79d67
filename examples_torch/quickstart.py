"""Quickstart: the paper's full pipeline through the port's public allocation
API (DESIGN.md §9), as ``examples/quickstart.py`` runs it on the reference.

  profile 4 heterogeneous apps -> fit Eq.(1) latency surfaces -> build an
  AllocRequest -> run the registered "crms" policy -> inspect the AllocResult
  (allocation + structured solve diagnostics).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The fit and every solve run on the CUDA device unless ``--device`` names
another (a RuntimeError without a card). ``main`` returns the printed values
as a dict.
"""
import argparse

import numpy as np

from repro_torch.api import AllocRequest, SolverOptions, allocate, get_policy, list_policies
from repro_torch.core.problem import ServerCaps
from repro_torch.core.profiler import make_paper_apps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    device = ap.parse_args(argv).device
    # the stateful policies start as in a new process, also when main runs
    # again in one (their state is the last deployment they saw)
    for name in ("crms_lifecycle", "crms_failover"):
        get_policy(name).reset()

    # 1. profile + fit (make_paper_apps(fitted=True) runs the §III measurement
    #    pipeline: noisy latency sweeps -> nonlinear least squares on Eq. (1))
    apps = make_paper_apps(lam=(8, 7, 10, 15), xbar=(5, 5, 5, 5), fitted=True, seed=0,
                           device=device)
    for a in apps:
        print(f"{a.name:18s} fitted kappa = ({a.kappa[0]:6.2f}, {a.kappa[1]:4.2f}, "
              f"{a.kappa[2]:4.2f})  lam={a.lam}  mem in [{a.r_min}, {a.r_max}] GB")

    # 2. optimize under the edge server's budgets (30 cores, 10 GB). Any policy
    #    in the registry takes the same request — swap "crms" for a baseline
    #    name to compare like-for-like.
    policies = list_policies()
    print(f"\nregistered policies: {', '.join(policies)}")
    request = AllocRequest(
        apps=apps,
        caps=ServerCaps(r_cpu=30.0, r_mem=10.0),
        alpha=1.4,
        beta=0.2,
        options=SolverOptions(),  # newton mode, grid seeding, refinement budget
        device=device,
    )
    result = allocate("crms", request)
    alloc = result.allocation

    # 3. inspect
    print(f"\nCRMS allocation  (utility {alloc.utility:.3f}, "
          f"feasible={alloc.feasible}, stable={alloc.stable})")
    print(f"{'app':18s} {'N':>3s} {'cpu/ctr':>8s} {'mem/ctr':>8s} {'Ws':>8s} {'power':>7s}")
    for i, a in enumerate(apps):
        print(f"{a.name:18s} {alloc.n[i]:3d} {alloc.r_cpu[i]:8.2f} {alloc.r_mem[i]:8.2f} "
              f"{alloc.ws[i]:7.3f}s {alloc.power_w[i]:6.1f}W")
    print(f"{'total':18s} {np.sum(alloc.n):3d} {alloc.total_cpu():8.2f} {alloc.total_mem():8.2f}")
    d = result.diagnostics
    print(f"\ndiagnostics: {d.refine_iters} refinement iters, "
          f"{d.accepted_moves} accepted moves, {d.p1_calls} batched P1 calls, "
          f"{d.wall_clock_s:.2f}s wall clock")

    # 4. container lifecycle (DESIGN.md §13): when spinning a container up
    #    costs seconds, re-planning is no longer free. "crms_lifecycle" runs
    #    the same CRMS solve but deploys it only when its modeled cost-rate
    #    gain over the re-plan horizon pays for the cold starts — and keeps
    #    warm pools sized to absorb a return to the recently observed peak.
    lifecycle_request = AllocRequest(
        apps=apps,
        caps=ServerCaps(r_cpu=30.0, r_mem=10.0),
        alpha=1.4, beta=0.2,
        extra={
            "lifecycle": {"t_cold": 2.0, "warm_pool": 0},  # 2 s cold-start lag
            "replan_horizon_s": 30.0,                      # decision epoch length
            "keep_warm": "auto",                           # peak-derived pools
        },
        device=device,
    )
    lr = allocate("crms_lifecycle", lifecycle_request)
    info = lr.diagnostics.extra["lifecycle"]
    print(f"\ncrms_lifecycle: deployed={info['deployed']} "
          f"(switch cost {info['switch_cost_j']:.1f} J, "
          f"bar {info['gain_rate_bar_w']:.3f} W), "
          f"keep-warm pools {lr.allocation.meta['keep_warm']}")

    # 5. failure-aware allocation (DESIGN.md §15): "crms_failover" hedges N+k
    #    spares at the deployed quotas from stationary availability
    #    MTBF/(MTBF+MTTR+t_cold), replaces observed-down containers
    #    one-for-one, and — when the post-crash budget cannot hold — sheds the
    #    lowest-priority load explicitly instead of failing silently.
    failover_request = AllocRequest(
        apps=apps,
        caps=ServerCaps(r_cpu=50.0, r_mem=18.0),  # headroom to place the spares
        alpha=1.4, beta=0.2,
        extra={"failures": {
            "spec": {"mtbf": 120.0, "mttr": 10.0},  # per-cluster crash law
            "down": {},                             # observed-crashed containers
            "t_cold": 2.0,                          # restart lag (part of outage)
        }},
        device=device,
    )
    fr = allocate("crms_failover", failover_request)
    fo = fr.diagnostics.extra["failover"]
    print(f"\ncrms_failover: reason={fo['reason']} "
          f"availability={fo['availability']:.4f} hedge={fo['hedge']:.2f} "
          f"(+{fo['k_extra']} spare containers), shed={fr.diagnostics.shed}")

    return {
        "kappa": [list(a.kappa) for a in apps],
        "policies": policies,
        "crms": {"n": alloc.n.tolist(), "r_cpu": alloc.r_cpu.tolist(),
                 "r_mem": alloc.r_mem.tolist(), "ws": alloc.ws.tolist(),
                 "power_w": alloc.power_w.tolist(), "utility": float(alloc.utility),
                 "feasible": bool(alloc.feasible), "stable": bool(alloc.stable),
                 "refine_iters": d.refine_iters, "accepted_moves": d.accepted_moves,
                 "p1_calls": d.p1_calls},
        "crms_lifecycle": {"deployed": info["deployed"], "switch_cost_j": info["switch_cost_j"],
                           "gain_rate_bar_w": info["gain_rate_bar_w"],
                           "keep_warm": lr.allocation.meta["keep_warm"]},
        "crms_failover": {"reason": fo["reason"], "availability": fo["availability"],
                          "hedge": fo["hedge"], "k_extra": fo["k_extra"],
                          "shed": list(fr.diagnostics.shed)},
    }


if __name__ == "__main__":
    main()
