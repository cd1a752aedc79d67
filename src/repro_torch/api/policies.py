"""Built-in allocation policies of the port: the paper's CRMS and its
priority-weighted variant, registered behind the one
``allocate(request) -> AllocResult`` contract.

Each adapter times the call and lifts solver diagnostics out of
``Allocation.meta`` into the structured AllocResult. The solve runs on
``request.device`` (None: the CUDA device).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.api.registry import register_policy
from repro_torch.api.types import AllocRequest, AllocResult, Diagnostics
from repro_torch.core.crms import crms
from repro_torch.core.problem import Allocation


def _result(alloc: Allocation, name: str, t0: float, **extra) -> AllocResult:
    diag = Diagnostics.from_meta(alloc.meta)
    diag.wall_clock_s = time.perf_counter() - t0
    diag.extra.update(extra)
    if not (alloc.feasible and alloc.stable):
        # no silent infeasibility: a failed solve is surfaced in diagnostics
        info = {"feasible": bool(alloc.feasible), "stable": bool(alloc.stable)}
        binding = alloc.meta.get("binding")
        if binding:
            info["binding"] = binding
        diag.extra.setdefault("infeasible", info)
    return AllocResult(allocation=alloc, policy=name, diagnostics=diag)


@register_policy("crms")
def crms_policy(request: AllocRequest) -> AllocResult:
    """The paper's CRMS (Algorithms 1+2) with the UNWEIGHTED Eq. (8)
    objective — any ``options.app_weights`` are stripped so this policy stays
    the paper baseline; priority weighting is ``crms_priority``'s job."""
    t0 = time.perf_counter()
    options = request.options
    if options.app_weights:
        options = dataclasses.replace(options, app_weights=())
    alloc = crms(
        request.apps,
        request.caps,
        request.alpha,
        request.beta,
        warm=request.warm,
        packed=request.packed,
        options=options,
        device=request.device,
    )
    return _result(alloc, "crms", t0)


@register_policy("crms_priority")
def crms_priority_policy(request: AllocRequest) -> AllocResult:
    """Priority-weighted CRMS: per-app weights scale the latency term to
    α·w_i·Ws_i through the whole pipeline (ideal configs, P1, refinement).
    Weights come from ``request.extra["weights"]`` (a {name: weight} mapping,
    wins when present) or ``request.options.app_weights``; with neither it is
    exactly the paper's CRMS."""
    t0 = time.perf_counter()
    options = request.options
    extra_w = request.extra.get("weights")
    if extra_w:
        options = dataclasses.replace(options, app_weights=dict(extra_w))
    alloc = crms(
        request.apps,
        request.caps,
        request.alpha,
        request.beta,
        warm=request.warm,
        packed=request.packed,
        options=options,
        device=request.device,
    )
    return _result(alloc, "crms_priority", t0, weights=dict(options.app_weights))
