"""CRMS-driven multi-tenant fleet scheduler — the paper's allocator operating
a TPU pod that serves all ten assigned architectures simultaneously.

Pipeline (mirrors the paper end to end):
  1. profile: per-arch latency measurements from the roofline model
     (core.fleet.profile_workload)
  2. fit: Eq.(1) latency surfaces over (chips/replica, HBM/replica)
  3. optimize: CRMS (Algorithm 1 + 2) under the pod's chip/HBM budgets
  4. actuate: replica groups sized accordingly; each group's Engine gets its
     batch slots from the HBM grant (serve/engine.py)

Quasi-dynamic: `FleetManager.observe(lam)` feeds arrival-rate drift; the
QuasiDynamicPolicy re-optimizes only past the threshold (§V-B).

``device`` (None: the CUDA device, a RuntimeError without one) is where the
fit and every solve run; pass ``"cpu"`` to run on the CPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api import AllocRequest, AllocResult, QuasiDynamicPolicy, SolverOptions
from repro_torch.core.engine import PackedApps
from repro_torch.core.fleet import WorkloadCost, build_fleet_apps, default_workloads, pod_caps
from repro_torch.core.problem import Allocation


@dataclasses.dataclass
class ReplicaGroup:
    arch: str
    chips: float
    hbm_gb: float
    batch_slots: int


class FleetManager:
    def __init__(self, workloads: list[WorkloadCost] | None = None,
                 n_chips: int = 256, alpha: float = 1.4, beta: float = 0.2,
                 threshold: float = 0.15, seed: int = 0,
                 options: SolverOptions | None = None, device=None):
        self.workloads = workloads or default_workloads()
        self.caps = pod_caps(n_chips)
        self.alpha, self.beta = alpha, beta
        self.device = device
        self.apps = build_fleet_apps(self.workloads, seed=seed, device=device)
        # the fleet owns the engine packing: one PackedApps per observation
        # epoch, shared by every batched P1/utility evaluation underneath
        self.packed = PackedApps.from_apps(self.apps)
        # the pod binding defaults to the structured O(M) Newton path with
        # grid-seeded phase-1 hints (the crms_grid kernel on the card).
        # SolverOptions is the one configuration object; the quasi-dynamic
        # caching/threshold behaviour is the generic policy decorator.
        self.options = options if options is not None else SolverOptions(
            qd_threshold=threshold
        )
        self.allocator = QuasiDynamicPolicy("crms", threshold=self.options.qd_threshold)
        self.last_result: AllocResult | None = None

    def observe(self, lam: dict[str, float]):
        self.apps = [a.with_lam(lam.get(a.name, a.lam)) for a in self.apps]
        self.packed = PackedApps.from_apps(self.apps)

    def plan(self) -> tuple[Allocation, list[ReplicaGroup]]:
        request = AllocRequest(
            apps=self.apps, caps=self.caps, alpha=self.alpha, beta=self.beta,
            packed=self.packed, options=self.options, device=self.device,
        )
        self.last_result = self.allocator.allocate(request)
        alloc = self.last_result.allocation
        groups = []
        for i, (app, w) in enumerate(zip(self.apps, self.workloads)):
            for _ in range(int(alloc.n[i])):
                slots = max(
                    int((alloc.r_mem[i] * 1e9 - w.params_bytes) / w.kv_bytes_per_seq), 1
                )
                groups.append(
                    ReplicaGroup(
                        arch=app.name,
                        chips=float(alloc.r_cpu[i]),
                        hbm_gb=float(alloc.r_mem[i]),
                        batch_slots=slots,
                    )
                )
        return alloc, groups
