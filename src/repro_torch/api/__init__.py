"""Public allocation-policy API of the port.

    from repro_torch.api import AllocRequest, SolverOptions, allocate

    result = allocate("crms", AllocRequest(apps, caps, alpha=1.4, beta=0.2))
    result.allocation            # the problem.Allocation
    result.diagnostics           # refinement iters, rescued rows, wall clock…

Submodules:
    types        — SolverOptions, AllocRequest, AllocResult, Diagnostics
    registry     — Policy protocol, register_policy, get_policy, allocate
    policies     — the built-ins: crms, crms_priority, crms_p95, the §VI
                   baselines snfc1/2, random_search, gpbo, tpebo and drf,
                   crms_fleet, robust_crms, robust_crms_p95, crms_lifecycle,
                   robust_crms_lifecycle, crms_shed, crms_failover,
                   predictive_crms
    quasidynamic — QuasiDynamicPolicy, the §V-B caching decorator, and
                   PredictivePolicy
    scenario     — Scenario/FleetScenario, events, ScenarioRunner (analytic
                   and des backends), FleetScenarioRunner, the BENCH_scenarios
                   schema 2.5 gate

Exports resolve lazily (PEP 562): ``repro_torch.core.crms`` imports the
contract types from here while ``repro_torch.api.policies`` imports the
solvers from core — laziness keeps that mutual dependency acyclic.
"""
from __future__ import annotations

_EXPORTS = {
    # types
    "SolverOptions": "repro_torch.api.types",
    "AllocRequest": "repro_torch.api.types",
    "AllocResult": "repro_torch.api.types",
    "Diagnostics": "repro_torch.api.types",
    "mean_latency_s": "repro_torch.api.types",
    "total_power_w": "repro_torch.api.types",
    # registry
    "Policy": "repro_torch.api.registry",
    "FunctionPolicy": "repro_torch.api.registry",
    "register_policy": "repro_torch.api.registry",
    "get_policy": "repro_torch.api.registry",
    "list_policies": "repro_torch.api.registry",
    "allocate": "repro_torch.api.registry",
    # the tail-aware built-in (registered as "crms_p95")
    "crms_p95_policy": "repro_torch.api.policies",
    # quasi-dynamic / predictive decorators
    "QuasiDynamicPolicy": "repro_torch.api.quasidynamic",
    "PredictivePolicy": "repro_torch.api.quasidynamic",
    # container lifecycle (cold starts + keep-warm; home: repro_torch.core.lifecycle)
    "LifecycleSpec": "repro_torch.core.lifecycle",
    "parse_lifecycle": "repro_torch.core.lifecycle",
    # failure injection (crash–repair + stragglers; home: repro_torch.core.failures)
    "FailureSpec": "repro_torch.core.failures",
    "parse_failures": "repro_torch.core.failures",
    # structured infeasibility (home: repro_torch.core.engine)
    "InfeasibleAllocation": "repro_torch.core.engine",
    # arrival laws (bursty/MMPP + trace ingestion; home: repro_torch.core.arrivals)
    "ArrivalSpec": "repro_torch.core.arrivals",
    "mmpp2": "repro_torch.core.arrivals",
    "estimate_arrival": "repro_torch.core.arrivals",
    "read_invocation_csv": "repro_torch.core.arrivals",
    "idc_asymptotic": "repro_torch.core.arrivals",
    "idc_at": "repro_torch.core.arrivals",
    # scenarios
    "Scenario": "repro_torch.api.scenario",
    "ScenarioRunner": "repro_torch.api.scenario",
    "EpochState": "repro_torch.api.scenario",
    "LambdaDrift": "repro_torch.api.scenario",
    "LambdaScale": "repro_torch.api.scenario",
    "LambdaSet": "repro_torch.api.scenario",
    "AppJoin": "repro_torch.api.scenario",
    "AppLeave": "repro_torch.api.scenario",
    "AppMigrate": "repro_torch.api.scenario",
    "CapResize": "repro_torch.api.scenario",
    "ContainerCrash": "repro_torch.api.scenario",
    "ContainerRepair": "repro_torch.api.scenario",
    "FleetScenario": "repro_torch.api.scenario",
    "FleetScenarioRunner": "repro_torch.api.scenario",
    "ScenarioEvent": "repro_torch.api.scenario",
    "validate_scenarios_doc": "repro_torch.api.scenario",
    "compact_scenarios_doc": "repro_torch.api.scenario",
    "expand_scenarios_doc": "repro_torch.api.scenario",
    "dumps_scenarios_doc": "repro_torch.api.scenario",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module_name = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
