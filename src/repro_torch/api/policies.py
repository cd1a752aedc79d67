"""Built-in allocation policies of the port: the paper's CRMS, its
priority-weighted variant and its tail-aware variant, registered behind the
one ``allocate(request) -> AllocResult`` contract.

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


def _p95_options(request: AllocRequest):
    """SolverOptions for the p95-aware policies: app_weights stripped (they
    stay the unweighted paper objective), ``tail_target`` defaulted to 0.95
    when the caller left it at the mean objective, and the DES rollout budget
    taken from ``request.extra["rollout_budget"]`` when present (else
    whatever ``options.rollout_budget`` grants; 0 = analytic surrogate)."""
    options = request.options
    changes = {}
    if options.app_weights:
        changes["app_weights"] = ()
    if not options.tail_target:
        changes["tail_target"] = 0.95
    if "rollout_budget" in request.extra:
        changes["rollout_budget"] = int(request.extra["rollout_budget"])
    if "rollout_horizon_s" in request.extra:
        changes["rollout_horizon_s"] = float(request.extra["rollout_horizon_s"])
    return dataclasses.replace(options, **changes) if changes else options


@register_policy("crms_p95")
def crms_p95_policy(request: AllocRequest) -> AllocResult:
    """Tail-aware CRMS (DESIGN.md §14): the α·Ws_i latency terms become the
    analytic p95 surrogate ``queueing.erlang_wait_quantile`` through the
    whole pipeline (P1 interior point, grid seeding, refinement scoring).
    When a DES budget is granted (``request.extra["rollout_budget"]`` or
    ``options.rollout_budget`` > 0) the greedy refinement scores each batch
    of 2M neighbor moves with ONE candidate-batched CRN rollout
    (des_vector.rollout_candidates, on ``request.device``) on ACHIEVED p95
    instead of the surrogate; with no budget it stays on the analytic path.
    The quantile comes from ``options.tail_target`` (default 0.95);
    ``request.seed`` feeds the rollout CRN streams."""
    t0 = time.perf_counter()
    options = _p95_options(request)
    alloc = crms(
        request.apps,
        request.caps,
        request.alpha,
        request.beta,
        warm=request.warm,
        packed=request.packed,
        options=options,
        seed=request.seed,
        device=request.device,
    )
    return _result(
        alloc, "crms_p95", t0,
        tail_target=float(options.tail_target),
        rollout_budget=int(options.rollout_budget),
    )


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
