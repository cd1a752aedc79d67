"""Public allocation-policy API of the port.

    from repro_torch.api import AllocRequest, SolverOptions, allocate

    result = allocate("crms", AllocRequest(apps, caps, alpha=1.4, beta=0.2))
    result.allocation            # the problem.Allocation
    result.diagnostics           # refinement iters, rescued rows, wall clock…

Submodules:
    types        — SolverOptions, AllocRequest, AllocResult, Diagnostics
    registry     — Policy protocol, register_policy, get_policy, allocate
    policies     — the built-ins: crms, crms_priority, crms_p95
    quasidynamic — QuasiDynamicPolicy, the §V-B caching decorator

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
    # quasi-dynamic decorator
    "QuasiDynamicPolicy": "repro_torch.api.quasidynamic",
    # structured infeasibility (home: repro_torch.core.engine)
    "InfeasibleAllocation": "repro_torch.core.engine",
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
