"""Built-in allocation policies of the port, registered behind the one
``allocate(request) -> AllocResult`` contract: the paper's CRMS, its
priority-weighted and tail-aware variants, the §VI baselines (``snfc1``,
``snfc2``, ``random_search``, ``gpbo``, ``tpebo``, ``drf``), the fleet
placement layer (``crms_fleet``), the burstiness-robust ladder
(``robust_crms``, ``robust_crms_p95``), the switching-cost-aware lifecycle
policies (``crms_lifecycle``, ``robust_crms_lifecycle``), graceful
degradation (``crms_shed``), failure-aware hedging (``crms_failover``) and
the predictive re-planner (``predictive_crms``).

Each adapter times the call and lifts solver diagnostics out of
``Allocation.meta`` into the structured AllocResult. Every solve and every
re-evaluation runs on ``request.device`` (None: the CUDA device).
"""
from __future__ import annotations

import dataclasses
import math
import time

from repro_torch.api.registry import register_policy
from repro_torch.api.types import AllocRequest, AllocResult, Diagnostics
from repro_torch.core import baselines
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


def _snfc(request: AllocRequest, name: str, r_cpu_fixed: float, r_mem_fixed) -> AllocResult:
    t0 = time.perf_counter()
    kw = {"r_cpu_fixed": r_cpu_fixed, "r_mem_fixed": r_mem_fixed}
    kw.update(request.extra)
    alloc = baselines.snfc(request.apps, request.caps, request.alpha, request.beta,
                           device=request.device, **kw)
    return _result(alloc, name, t0)


@register_policy("snfc1")
def snfc1_policy(request: AllocRequest) -> AllocResult:
    """Scale-number-fixed-config, paper SNFC1: c=1.8 cores, m=0.35 GB."""
    return _snfc(request, "snfc1", 1.8, 0.35)


@register_policy("snfc2")
def snfc2_policy(request: AllocRequest) -> AllocResult:
    """Scale-number-fixed-config, paper SNFC2: c=1.0 core, m=r_max."""
    return _snfc(request, "snfc2", 1.0, "rmax")


@register_policy("random_search")
def random_search_policy(request: AllocRequest) -> AllocResult:
    t0 = time.perf_counter()
    kw = {"n_samples": 20000, "seed": request.seed}
    kw.update(request.extra)
    alloc = baselines.random_search(request.apps, request.caps, request.alpha, request.beta,
                                    device=request.device, **kw)
    return _result(alloc, "random_search", t0, n_samples=kw["n_samples"])


@register_policy("gpbo")
def gpbo_policy(request: AllocRequest) -> AllocResult:
    t0 = time.perf_counter()
    kw = {"seed": request.seed}
    kw.update(request.extra)
    alloc = baselines.gpbo(request.apps, request.caps, request.alpha, request.beta,
                           device=request.device, **kw)
    return _result(alloc, "gpbo", t0)


@register_policy("tpebo")
def tpebo_policy(request: AllocRequest) -> AllocResult:
    t0 = time.perf_counter()
    kw = {"seed": request.seed}
    kw.update(request.extra)
    alloc = baselines.tpebo(request.apps, request.caps, request.alpha, request.beta,
                            device=request.device, **kw)
    return _result(alloc, "tpebo", t0)


@register_policy("drf")
def drf_policy(request: AllocRequest) -> AllocResult:
    """Dominant-resource-fairness progressive filling; may return unstable
    allocations (the paper's APP2/APP4 pathology) — recorded honestly."""
    t0 = time.perf_counter()
    alloc = baselines.drf(request.apps, request.caps, request.alpha, request.beta,
                          device=request.device)
    return _result(alloc, "drf", t0)


class CrmsFleetPolicy:
    """Fleet-of-fleets placement (core.placement.FleetPlanner) behind the
    allocation contract: apps spread across N nodes, per-node CRMS-style P1
    inner allocations solved as one batched row solve on ``request.device``.

    Fleet shape comes in through ``request.extra``:

    node_caps       (required) sequence of (cpu, mem) pairs or ServerCaps
    migrations      optional [(app_name, dst_node), ...] applied this epoch
    exchange_rounds optional outer-refinement rounds on cold plans (default 2)
    mesh            not available: the row solve runs on one device, and a
                    mesh raises NotImplementedError

    STATEFUL singleton like predictive_crms (self_caching): the first call
    (or any change of app-name set / fleet shape / objective weights /
    device) runs a cold plan — greedy placement + exchange + full row solve;
    subsequent calls run the incremental re-plan, re-solving only the nodes
    touched by λ drift and migrations. ``reset()`` drops the placement
    state."""

    self_caching = True

    def __init__(self, name: str = "crms_fleet"):
        self.name = name
        self._planner = None
        self._key = None

    def reset(self) -> None:
        self._planner = None
        self._key = None

    def allocate(self, request: AllocRequest) -> AllocResult:
        from repro_torch.core.placement import FleetPlanner

        t0 = time.perf_counter()
        node_caps = request.extra.get("node_caps")
        if node_caps is None:
            raise ValueError("crms_fleet needs request.extra['node_caps']")
        caps_key = tuple(
            (float(c.r_cpu), float(c.r_mem)) if hasattr(c, "r_cpu") else (float(c[0]), float(c[1]))
            for c in node_caps
        )
        key = (request.names(), caps_key, float(request.alpha), float(request.beta),
               str(request.device))
        migrations = tuple(request.extra.get("migrations", ()))
        if self._planner is None or key != self._key:
            self._planner = FleetPlanner(
                request.apps,
                node_caps,
                alpha=request.alpha,
                beta=request.beta,
                exchange_rounds=int(request.extra.get("exchange_rounds", 2)),
                mesh=request.extra.get("mesh"),
                seed=request.seed,
                device=request.device,
            )
            self._key = key
            plan = self._planner.plan()
            if migrations:
                plan = self._planner.replan(migrations=migrations)
        else:
            plan = self._planner.replan(
                lam={a.name: a.lam for a in request.apps},
                migrations=migrations,
            )
        pl = self._planner
        power_w = pl.power_span * plan.n * plan.r_cpu / pl.caps_cpu[plan.assignment]
        ok = bool(plan.node_ok.all())
        alloc = Allocation(
            n=plan.n.copy(),
            r_cpu=plan.r_cpu.copy(),
            r_mem=plan.r_mem.copy(),
            utility=plan.utility,
            ws=plan.ws.copy(),
            power_w=power_w,
            feasible=ok,
            stable=ok,
            meta={
                "diagnostics": dict(plan.diagnostics),
                "assignment": plan.assignment.tolist(),
                "node_utility": plan.node_utility.tolist(),
            },
        )
        return _result(
            alloc, self.name, t0,
            cold=bool(plan.diagnostics.get("cold", False)),
            width=plan.diagnostics.get("width"),
            M_pad=plan.diagnostics.get("M_pad"),
            nodes_failed=plan.diagnostics.get("nodes_failed", 0),
            exchange_accepted=plan.diagnostics.get("exchange_accepted", 0),
        )


# Stateful like predictive_crms (see below): the placement state IS the value.
register_policy("crms_fleet")(CrmsFleetPolicy())


@register_policy("robust_crms")
def robust_crms_policy(request: AllocRequest) -> AllocResult:
    """Burstiness-robust CRMS: optimize against the top of each app's
    [λ_mean, λ_hi] arrival-rate uncertainty interval instead of the mean.

    Erlang-C Ws is increasing in λ, so the interval's worst case is its upper
    endpoint: solving P1 at λ_eff = λ·(1 + t·(ratio − 1)) IS the worst-case
    robust solve, reusing the whole structured-Newton pipeline unchanged.
    Per-app ratios λ_hi/λ_mean come from ``request.extra``:

    * ``"arrival_ratios"``: {app_name: ratio} — the ScenarioRunner injects
      each app's MMPP peak-phase rate ratio (``ArrivalSpec.lam_hi_ratio``),
      estimated from a trace or declared in the scenario;
    * ``"robust"``: one explicit ratio for every app (wins when present).

    The inflation backs off (t = 1 → 0 over a fixed ladder) until the solve
    is feasible AND stable — full robustness when capacity allows, degrading
    toward plain CRMS under pressure rather than failing. The returned
    allocation is re-evaluated at the TRUE mean rates (the PredictivePolicy
    idiom), so recorded utility/Ws describe the real operating point, not
    the inflated one. With no ratios (pure Poisson) every app's interval
    collapses and this policy is exactly ``crms`` — same draws, same answer.
    Like ``crms``, any ``options.app_weights`` are stripped."""
    options = request.options
    if options.app_weights:
        options = dataclasses.replace(options, app_weights=())
    return _robust_allocate(request, options, "robust_crms")


@register_policy("robust_crms_p95")
def robust_crms_p95_policy(request: AllocRequest) -> AllocResult:
    """``robust_crms`` ∘ ``crms_p95``: the shared worst-case λ ladder wraps
    the tail-aware solver, so burst robustness and p95 awareness stack. Each
    ladder rung solves CRMS at the inflated rates with the p95-surrogate
    objective (plus the CRN rollout scoring when a DES budget is granted —
    see ``crms_p95``); the honest re-score at the true mean rates keeps the
    tail objective, so ``utility``/``meta["p95_surrogate_s"]`` describe the
    real operating point (DESIGN.md §14)."""
    return _robust_allocate(request, _p95_options(request), "robust_crms_p95")


def _robust_allocate(request: AllocRequest, options, name: str) -> AllocResult:
    """The worst-case arrival-rate ladder shared by ``robust_crms`` and
    ``robust_crms_p95``: back off t = 1 → 0 over a fixed ladder of
    λ_eff = λ·(1 + t·(ratio − 1)) until CRMS is feasible AND stable, then
    re-evaluate honestly at the true mean rates. The caller has already
    normalized ``options`` (weights stripped; tail/rollout knobs set)."""
    import numpy as np

    from repro_torch.core.problem import evaluate

    t0 = time.perf_counter()
    tail_q = float(options.tail_target)
    explicit = request.extra.get("robust")
    ratio_map = request.extra.get("arrival_ratios") or {}
    ratios = np.array(
        [
            float(explicit) if explicit is not None else float(ratio_map.get(a.name, 1.0))
            for a in request.apps
        ]
    )
    if np.any(ratios < 1.0):
        raise ValueError(
            f"{name} ratios must be >= 1 (lam_hi/lam_mean), got {ratios.min()}"
        )
    kw = dict(warm=request.warm, options=options, seed=request.seed,
              device=request.device)
    if np.all(ratios == 1.0):
        alloc = crms(
            request.apps, request.caps, request.alpha, request.beta,
            packed=request.packed, **kw,
        )
        return _result(alloc, name, t0, robust_t=0.0, robust_ratio_max=1.0)
    cand = None
    for t in (1.0, 0.6, 0.35, 0.15, 0.0):
        eff = [
            a.with_lam(a.lam * (1.0 + t * (r - 1.0)))
            for a, r in zip(request.apps, ratios)
        ]
        # request.packed (if any) carries the TRUE rates — never reuse it for
        # an inflated rung
        cand = crms(eff, request.caps, request.alpha, request.beta, **kw)
        if cand.feasible and cand.stable:
            break
    # honest re-score at the true mean rates (t=0 re-evaluates to itself, so
    # the fully-backed-off case stays numerically identical to the unwrapped
    # policy)
    alloc = evaluate(
        request.apps, cand.n, cand.r_cpu, cand.r_mem,
        request.caps, request.alpha, request.beta, tail_q=tail_q,
        device=request.device,
    )
    meta = dict(cand.meta)
    meta.update(alloc.meta)  # true-rate surrogate wins over the rung's
    alloc.meta = meta
    return _result(
        alloc, name, t0,
        robust_t=float(t), robust_ratio_max=float(ratios.max()),
    )


class LifecyclePolicy:
    """Switching-cost-aware CRMS (``crms_lifecycle``): plain CRMS solves,
    deployed only when they pay for their own cold starts.

    The paper's quasi-dynamic scheme re-plans on a TUNED relative-λ-drift
    threshold (``options.qd_threshold``); this policy DERIVES the re-plan
    bar from the container lifecycle model instead (core/lifecycle.py,
    DESIGN.md §13). Every epoch it:

    1. solves plain CRMS for the current mix (byte-identical to the ``crms``
       policy — same draws, same allocation);
    2. sizes per-app keep-warm pools for the candidate —
       ``request.extra["keep_warm"]`` ("auto" default: ``auto_warm_pool``
       sized from the recent per-app λ peak, memory-feasible; or an explicit
       int / {app: int} / per-app sequence);
    3. re-evaluates the cached incumbent at the CURRENT rates and accepts
       the candidate iff ``(C_old − C_new)·H_eff > β·E_boot`` — the modeled
       cost-rate gain over the re-plan horizon must exceed the boot energy
       of the spin-ups the incumbent's warm pool cannot absorb
       (``lifecycle.switch_decision``).

    Accepted allocations carry ``meta["keep_warm"]`` (the DES replay feeds
    it to ``configure(warm_pool=...)``) and account the pools honestly:
    per-app idle draw (``power.warm_power``) is added to ``power_w`` and
    β·P_warm_i/λ_i to the recorded utility. Rejections return the cached
    incumbent (``cached_view`` — the runner records replanned=False) with
    the full decision record under ``diagnostics.extra["lifecycle"]``.

    Lifecycle knobs ride in ``request.extra``:

    lifecycle        : LifecycleSpec / dict / bare t_cold seconds (the
                       ScenarioRunner injects the scenario's spec). Absent
                       or t_cold = 0 → the bar is zero, every fresh solve
                       deploys, pools are empty: EXACTLY plain crms.
    replan_horizon_s : gain horizon H (the runner injects its epoch_s).
    keep_warm        : pool sizing, default "auto" (see above).

    STATEFUL singleton (``self_caching``) like predictive_crms: the cached
    incumbent + λ-peak history ARE the state; the ScenarioRunner resets it
    before each replay. A mix/caps/objective change drops the cache (forced
    accept — the incumbent is not comparable), as does an incumbent gone
    unstable at the current rates (C_old = ∞ loses to any stable candidate).

    ``inner`` swaps the per-epoch solver: ``robust_crms_lifecycle`` composes
    the worst-case λ ladder (``robust_crms``) with this accept rule. At
    ``t_cold = 0`` the bar is zero and pools are empty, so either variant is
    allocation-identical to its inner policy (pinned by tests).
    """

    self_caching = True

    def __init__(self, name: str = "crms_lifecycle", history: int = 8,
                 inner=None):
        self.name = name
        self.history = int(history)
        self._inner = inner  # None -> crms_policy (resolved at call time)
        self.reset()

    def reset(self) -> None:
        self._key = None
        self._lam_hist = None  # recent per-app λ vectors (peak tracking)
        self._last = None  # AllocResult of the deployed incumbent
        self._warm = None  # (M,) int keep-warm pool targets of the incumbent

    def allocate(self, request: AllocRequest) -> AllocResult:
        import collections

        import numpy as np

        from repro_torch.core import lifecycle as lc
        from repro_torch.core.power import warm_power
        from repro_torch.core.problem import evaluate

        t0 = time.perf_counter()
        spec = lc.parse_lifecycle(request.extra.get("lifecycle"))
        horizon = float(request.extra.get("replan_horizon_s", 60.0))
        names = request.names()
        lam = request.lam()
        caps = request.caps
        key = (
            names, float(caps.r_cpu), float(caps.r_mem),
            float(request.alpha), float(request.beta),
        )
        if key != self._key:  # first call / mix / caps / objective change
            self._key = key
            self._lam_hist = collections.deque(maxlen=self.history)
            self._last = None
            self._warm = None
        self._lam_hist.append(lam)
        lam_peak = np.max(np.stack(self._lam_hist), axis=0)

        cand = (self._inner or crms_policy)(request)  # byte-identical inner solve
        alloc = cand.allocation
        warm = lc.normalize_keep_warm(request.extra.get("keep_warm", "auto"), names)
        if warm is None:
            warm = lc.auto_warm_pool(
                alloc.n, lam, lam_peak, spec, alloc.r_mem, caps.r_mem
            )
        wp_new = lc.warm_pool_power_w(warm, alloc.r_cpu, caps.r_cpu, caps.power)
        cost_new = lc.cost_rate_w(
            lam, alloc.ws, alloc.power_w, request.alpha, request.beta, wp_new
        )

        if self._last is None or spec.t_cold <= 0.0:
            decision = {
                "accept": True, "forced": self._last is None,
                "gain_rate_w": None, "switch_cost_j": 0.0,
                "gain_rate_bar_w": 0.0, "spin_ups": 0,
            }
        else:
            old = self._last.allocation
            old_eval = evaluate(
                request.apps, old.n, old.r_cpu, old.r_mem,
                caps, request.alpha, request.beta, device=request.device,
            )
            wp_old = lc.warm_pool_power_w(
                self._warm, old.r_cpu, caps.r_cpu, caps.power
            )
            cost_old = lc.cost_rate_w(
                lam, old_eval.ws, old_eval.power_w,
                request.alpha, request.beta, wp_old,
            )
            spin = np.maximum(alloc.n - old.n - self._warm, 0)
            decision = lc.switch_decision(
                cost_old, cost_new, spin, alloc.r_cpu, caps.r_cpu,
                spec.t_cold, horizon, request.beta, caps.power,
            )
            decision["cost_old_w"] = cost_old if math.isfinite(cost_old) else None
            decision["forced"] = False
        decision["cost_new_w"] = cost_new if math.isfinite(cost_new) else None
        decision["t_cold"] = spec.t_cold
        decision["horizon_s"] = horizon

        if not decision["accept"]:
            view = self._last.cached_view()
            view.diagnostics.extra = {
                **self._last.diagnostics.extra,
                "lifecycle": {**decision, "deployed": False},
            }
            return view

        if np.any(warm > 0):  # honest pool accounting (never at t_cold = 0)
            wp_i = np.asarray(
                warm_power(
                    warm.astype(float), alloc.r_cpu, caps.r_cpu, caps.power
                ),
                dtype=float,
            )
            alloc = dataclasses.replace(
                alloc,
                power_w=(
                    alloc.power_w + wp_i if alloc.power_w is not None else None
                ),
                utility=float(
                    alloc.utility
                    + request.beta * np.sum(wp_i / np.maximum(lam, 1e-12))
                ),
                meta=dict(alloc.meta),
            )
        alloc.meta["keep_warm"] = [int(w) for w in warm]
        alloc.meta["lifecycle"] = spec.to_dict()
        result = _result(
            alloc, self.name, t0, lifecycle={**decision, "deployed": True},
            keep_warm=[int(w) for w in warm],
        )
        self._last = result
        self._warm = np.asarray(warm, dtype=int)
        return result


# Stateful singleton (the incumbent cache + λ-peak history carry across
# epochs); the ScenarioRunner resets it before each trace replay.
register_policy("crms_lifecycle")(LifecyclePolicy())

# robust_crms ∘ the lifecycle accept rule: each epoch's
# candidate comes from the worst-case λ ladder, deployed only when it pays
# for its own cold starts. At t_cold = 0 this is exactly robust_crms.
register_policy("robust_crms_lifecycle")(
    LifecyclePolicy("robust_crms_lifecycle", inner=robust_crms_policy)
)


# ----------------------------------------------------------------------------
# Graceful degradation: the deterministic load-shedding ladder
# ----------------------------------------------------------------------------
_SHED_FRACS = (0.75, 0.5, 0.25, 0.0)


def _shed_order(request: AllocRequest) -> list:
    """Deterministic shed order: ascending (weight, λ, name) — the
    lowest-priority app is throttled first; among equal weights the smaller
    tenant goes first, names break exact ties. Pure function of the request,
    so replays shed identically."""
    weights = dict(request.options.app_weights)
    return sorted(
        request.apps,
        key=lambda a: (weights.get(a.name, 1.0), float(a.lam), a.name),
    )


def _shed_allocate(request: AllocRequest, solve, name: str, t0: float,
                   **extra) -> AllocResult:
    """Admission-control ladder (DESIGN.md §15): when ``solve`` cannot
    stabilize all M apps, walk the deterministic ladder — throttle the
    lowest-priority app's accepted arrival rate through ``_SHED_FRACS``
    (0.75 → 0.5 → 0.25 → drop), then the next app, until the admitted set is
    feasible AND stable. The final rung (everything dropped) is vacuously
    feasible, so this NEVER returns silent infeasibility: the result always
    reports exactly what was shed (``diagnostics.shed`` +
    ``extra["admission"]``) and carries ``meta["admission"]`` for the DES
    replay (λ·frac per app; frac = 0 retires the cluster)."""
    import numpy as np

    res = solve(request)
    if res.feasible and res.stable:
        return res

    names = request.names()
    frac = {nm: 1.0 for nm in names}
    first_fail = {"feasible": bool(res.feasible), "stable": bool(res.stable)}
    attempt = None
    for app in _shed_order(request):
        for f in _SHED_FRACS:
            frac[app.name] = f
            active = [
                a.with_lam(a.lam * frac[a.name])
                for a in request.apps
                if frac[a.name] > 0.0
            ]
            if not active:
                attempt = None  # everything shed: the vacuous admitted set
                break
            sub = dataclasses.replace(
                request, apps=tuple(active), warm=None, packed=None
            )
            attempt = solve(sub)
            if attempt.feasible and attempt.stable:
                break
        else:
            continue
        break

    M = len(names)
    shed = [nm for nm in names if frac[nm] < 1.0]
    n = np.zeros(M, dtype=int)
    r_cpu = np.zeros(M)
    r_mem = np.zeros(M)
    ws = np.full(M, np.inf)  # a refused request never completes
    power_w = np.zeros(M)
    utility = 0.0
    meta: dict = {}
    if attempt is not None:
        sub_alloc = attempt.allocation
        active_names = [nm for nm in names if frac[nm] > 0.0]
        idx = {nm: i for i, nm in enumerate(names)}
        for j, nm in enumerate(active_names):
            i = idx[nm]
            n[i] = int(sub_alloc.n[j])
            r_cpu[i] = float(sub_alloc.r_cpu[j])
            r_mem[i] = float(sub_alloc.r_mem[j])
            if sub_alloc.ws is not None:
                ws[i] = float(sub_alloc.ws[j])
            if sub_alloc.power_w is not None:
                power_w[i] = float(sub_alloc.power_w[j])
        utility = float(sub_alloc.utility)
        meta = dict(sub_alloc.meta)
    meta["admission"] = {nm: float(frac[nm]) for nm in names}
    meta["shed"] = list(shed)
    alloc = Allocation(
        n=n, r_cpu=r_cpu, r_mem=r_mem, utility=utility, ws=ws,
        power_w=power_w, feasible=True, stable=True, meta=meta,
    )
    result = _result(
        alloc, name, t0,
        admission={nm: float(frac[nm]) for nm in names},
        shed_from=first_fail, **extra,
    )
    result.diagnostics.shed = list(shed)
    return result


@register_policy("crms_shed")
def crms_shed_policy(request: AllocRequest) -> AllocResult:
    """CRMS with graceful degradation: exactly ``crms`` while the budget can
    stabilize every app (same draws, same allocation), else the deterministic
    load-shedding ladder (``_shed_allocate``) throttles or drops the
    lowest-priority apps until the admitted set is feasible — with the shed
    set always reported, never a silent masked-row failure."""
    return _shed_allocate(
        request, crms_policy, "crms_shed", time.perf_counter()
    )


class FailoverPolicy:
    """Failure-aware CRMS (``crms_failover``, DESIGN.md §15): N+k hedged
    capacity from stationary availability, bounded crash-reaction re-plans,
    and the load-shedding ladder when the post-crash budget cannot hold.

    Per epoch, with failures active (``request.extra["failures"]`` injected
    by the ScenarioRunner, or passed directly):

    1. solve plain CRMS for the current mix (byte-identical to ``crms``);
    2. hedge: availability a = MTBF/(MTBF + MTTR + t_cold) (the restart lag
       is part of the outage), target counts n_h = ceil(n/a) + down —
       provision so the EXPECTED healthy capacity covers the plan, plus a
       replacement for every observed-crashed container. The spares keep
       the DEPLOYED per-container quotas (re-solving quotas at the hedged
       counts would dilute every container's μ — paying the hedge in
       latency instead of power); the hedged candidate is evaluated
       honestly against the budget and backs off over h ∈ (1, 0.5, 0.25, 0)
       of the extra containers until feasible AND stable — full hedging
       when headroom allows, degrading toward plain CRMS under pressure;
    3. when even the unhedged solve cannot stabilize all apps, the
       ``_shed_allocate`` ladder sheds lowest-priority load and reports it;
    4. re-plans are BOUNDED: between crash notifications (the runner
       forwards ``sim.downs()``) the policy re-plans only on λ drift beyond
       ``options.qd_threshold`` (the quasi-dynamic bar); consecutive
       crash-triggered re-plans double a cooldown (1 → 4 epochs) so a
       crash-looping cluster cannot thrash the solver, and a quiet epoch
       resets the backoff.

    With failures absent/inactive the fast path returns the ``crms``
    allocation byte-identically (pinned by BENCH_failure.json's identity
    gate). STATEFUL singleton (``self_caching``): the deployed incumbent,
    last-seen down map and crash-backoff state carry across epochs; the
    ScenarioRunner resets it before each replay."""

    self_caching = True

    def __init__(self, name: str = "crms_failover"):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self._key = None
        self._last = None  # deployed incumbent (AllocResult)
        self._last_lam = None
        self._last_down: dict = {}
        self._cooldown = 0  # epochs left before another crash-triggered re-plan
        self._cooldown_len = 1  # doubles 1 -> 4 on consecutive crash re-plans

    def allocate(self, request: AllocRequest) -> AllocResult:
        import numpy as np

        from repro_torch.core.failures import parse_failures

        t0 = time.perf_counter()
        fail = request.extra.get("failures")
        if isinstance(fail, dict) and (
            "spec" in fail or "down" in fail or "t_cold" in fail
        ):
            spec = parse_failures(fail.get("spec"))
            down = {str(k): int(v) for k, v in (fail.get("down") or {}).items()}
            t_cold = float(fail.get("t_cold", 0.0))
        else:
            spec = parse_failures(fail)
            down, t_cold = {}, 0.0

        if not spec.active and not any(down.values()):
            # no stochastic failures AND nothing currently crashed (scripted
            # ContainerCrash traces keep the stateful path via ``down``)
            res = crms_policy(request)  # byte-identical fast path
            res.policy = self.name
            res.diagnostics.extra["failover"] = {"active": False}
            return res

        names = request.names()
        lam = request.lam()
        key = (
            names, float(request.caps.r_cpu), float(request.caps.r_mem),
            float(request.alpha), float(request.beta), spec,
        )
        if key != self._key:
            self.reset()
            self._key = key

        new_crashes = any(
            down.get(nm, 0) > self._last_down.get(nm, 0) for nm in names
        )
        drift = (
            float(np.max(np.abs(lam - self._last_lam)
                         / np.maximum(self._last_lam, 1e-12)))
            if self._last_lam is not None else float("inf")
        )
        reason = None
        if self._last is None:
            reason = "cold"
        elif drift > float(request.options.qd_threshold):
            reason = "drift"
        elif new_crashes:
            if self._cooldown == 0:
                reason = "crash"
                self._cooldown = self._cooldown_len
                self._cooldown_len = min(self._cooldown_len * 2, 4)
            # else: bounded backoff — ride the hedged incumbent this epoch
        if reason is None and self._cooldown > 0:
            self._cooldown -= 1  # ticked AFTER the check: a cooldown of k
            # suppresses crash re-plans for exactly the next k epochs
        if not new_crashes:
            self._cooldown_len = 1  # a quiet epoch resets the backoff
        if reason is not None or not new_crashes:
            # a crash suppressed by the cooldown stays "unseen" so the re-plan
            # RETRIES once the backoff expires (bounded, not dropped)
            self._last_down = dict(down)
        if reason is not None:
            self._last_lam = lam  # drift is measured against the deployed plan

        if reason is None:
            view = self._last.cached_view()
            view.diagnostics.extra = {
                **self._last.diagnostics.extra,
                "failover": {
                    **self._last.diagnostics.extra.get("failover", {}),
                    "reason": "cached", "cooldown": self._cooldown,
                    "down": dict(down),
                },
            }
            return view

        avail = spec.availability(t_cold)
        result = self._hedged_solve(request, spec, avail, down, reason, t0)
        self._last = result
        return result

    def _hedged_solve(self, request, spec, avail, down, reason, t0):
        import numpy as np

        from repro_torch.core.problem import evaluate

        diag = {
            "active": True, "availability": float(avail), "reason": reason,
            "cooldown": self._cooldown, "down": dict(down),
            "mtbf": spec.mtbf, "mttr": spec.mttr,
        }
        base = crms_policy(request)
        if not (base.feasible and base.stable):
            # post-crash budget cannot stabilize all M apps: shed, never fail
            return _shed_allocate(
                request, crms_policy, self.name, t0,
                failover={**diag, "hedge": 0.0, "k_extra": 0, "shed": True},
            )
        n0 = np.asarray(base.allocation.n, dtype=int)
        k_extra = np.ceil(n0 / max(avail, 1e-9)).astype(int) - n0
        # crashed-and-not-repaired containers serve nothing: provisioning
        # n + down restores the EFFECTIVE capacity the solver planned for.
        # The replacement term is observed (deterministic), the availability
        # hedge is expected (stochastic); the backoff ladder scales both.
        repl = np.array(
            [int(down.get(nm, 0)) for nm in request.names()], dtype=int
        )
        k_extra = k_extra + repl
        chosen = None
        level = 0.0
        if np.any(k_extra > 0):
            # spares at the DEPLOYED quotas: a hedged container is a clone of
            # the base config, so nominal latency only improves and a crash
            # removes a smaller fraction of capacity. Re-solving quotas at
            # the hedged counts would shrink every container's μ instead —
            # paying the hedge in latency, which loses exactly when nothing
            # fails. Backed off until the spares fit the budget.
            for h in (1.0, 0.5, 0.25):
                n_h = n0 + np.ceil(h * k_extra).astype(int)
                alloc = evaluate(
                    request.apps, n_h,
                    np.asarray(base.allocation.r_cpu, dtype=float),
                    np.asarray(base.allocation.r_mem, dtype=float),
                    request.caps, request.alpha, request.beta,
                    device=request.device,
                )
                if alloc.feasible and alloc.stable:
                    chosen, level = alloc, h
                    break
        if chosen is None:
            # no hedge fits (or none was needed): deploy the plain solve
            res = _result(
                base.allocation, self.name, t0,
                failover={**diag, "hedge": 0.0,
                          "k_extra": int(np.sum(k_extra))},
            )
            return res
        return _result(
            chosen, self.name, t0,
            failover={**diag, "hedge": float(level),
                      "k_extra": int(np.sum(np.ceil(level * k_extra)))},
        )


# Stateful singleton (incumbent + crash-backoff state carry across epochs);
# the ScenarioRunner resets it before each trace replay.
register_policy("crms_failover")(FailoverPolicy())


def _register_predictive() -> None:
    # Imported here (not at module top): quasidynamic imports the registry,
    # which is mid-load while this module registers the built-ins.
    from repro_torch.api.quasidynamic import PredictivePolicy

    register_policy("predictive_crms")(
        PredictivePolicy("crms", name="predictive_crms")
    )


# The predictive re-planner over CRMS. Unlike every other built-in this is a
# STATEFUL singleton — its value is the λ history carried across calls. The
# ScenarioRunner calls .reset() before each trace replay; direct registry
# users replaying an unrelated trace with the same app names/caps must do the
# same (get_policy("predictive_crms").reset()) or build their own
# PredictivePolicy("crms") instance.
_register_predictive()
