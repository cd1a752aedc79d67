"""Contract types of the public allocation API.

One request/result shape for every allocation policy:

    SolverOptions : frozen CRMS solver configuration; the single option
                    object flows from the policy down to crms().
    AllocRequest  : everything a policy needs to produce an allocation
                    (apps, caps, weights, warm state, shared packing, options).
    AllocResult   : the Allocation plus structured Diagnostics (refinement
                    iterations, accepted moves, phase-1 rescued/masked rows,
                    warm-vs-cold, wall-clock).

This module is a leaf: it imports ``repro_torch.core.problem`` for annotations
only, so that core modules (crms) can import the contract types without
cycles. The port adds one field to the contract: ``AllocRequest.device``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping, Sequence

import numpy as np

if TYPE_CHECKING:  # annotation-only: keeps this module a true leaf —
    # repro_torch.core.crms imports SolverOptions from here, so importing core at
    # runtime would be a cycle
    from repro_torch.core.problem import Allocation, App, ServerCaps

_NEWTON_MODES = ("structured", "dense")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """CRMS solver configuration, immutable so it can be shared freely.

    newton           : Newton direction of the batched engine — "structured"
                       (O(M) analytic default) or "dense" (autodiff escape
                       hatch kept for parity testing).
    grid_seed        : seed refinement phase-1 CPU hints from the coarse
                       (c, m) utility grid sweep (engine.grid_seed_chints).
    max_refine_iters : Algorithm 2 greedy refinement iteration budget.
    refine_profile   : barrier schedule for refinement P1 batches — a key of
                       engine.P1_PROFILES ("refine" default, "reference" for
                       the over-converged seed schedule).
    qd_threshold     : relative λ-drift threshold of the quasi-dynamic driver
                       (§V-B); consumed by QuasiDynamicPolicy, ignored by a
                       bare single-shot solve.
    app_weights      : per-app priority weights for the latency term — pairs
                       of (app name, weight); apps not named weigh 1.0. A
                       weight w_i scales the α·Ws_i term of Eq. (8) to
                       α·w_i·Ws_i throughout the CRMS pipeline (Algorithm 1
                       ideal configs, the P1 interior point, grid seeding and
                       the greedy refinement objective). Accepts a mapping or
                       an iterable of pairs; normalized to a sorted tuple so
                       the options object stays frozen/hashable. Consumed by
                       the priority-weighted CRMS policy (``crms_priority``);
                       the plain ``crms`` policy keeps the paper's unweighted
                       objective.
    tail_target      : latency-tail quantile for the P1 objective. 0.0 (the
                       default) keeps the paper's mean-latency objective;
                       q in (0, 1) — e.g. 0.95 for ``crms_p95`` — replaces
                       every α·Ws_i term with the analytic response-time
                       quantile surrogate ``queueing.erlang_wait_quantile``
                       (Ws + ln(C/(1−q))/(Nμ−λ)) through the interior point,
                       the grid seeding and the refinement scoring
                       (DESIGN.md §14).
    rollout_budget   : number of batched CRN DES rollout calls the greedy
                       refinement may spend scoring its 2M neighbor moves
                       (core/des_vector.rollout_candidates) — one call scores
                       the whole move batch. 0 (default) grants no DES
                       budget: refinement stays on the analytic surrogate.
    rollout_horizon_s: simulated seconds per rollout call (CRN pairing makes
                       short horizons decisive; the first 20% is warmup).
    """

    newton: str = "structured"
    grid_seed: bool = True
    max_refine_iters: int = 64
    refine_profile: str = "refine"
    qd_threshold: float = 0.15
    app_weights: tuple = ()
    tail_target: float = 0.0
    rollout_budget: int = 0
    rollout_horizon_s: float = 40.0

    def __post_init__(self):
        if self.newton not in _NEWTON_MODES:
            raise ValueError(f"newton must be one of {_NEWTON_MODES}, got {self.newton!r}")
        if self.max_refine_iters < 0:
            raise ValueError(f"max_refine_iters must be >= 0, got {self.max_refine_iters}")
        if not 0.0 <= self.qd_threshold:
            raise ValueError(f"qd_threshold must be >= 0, got {self.qd_threshold}")
        if not (self.tail_target == 0.0 or 0.0 < self.tail_target < 1.0):
            raise ValueError(
                f"tail_target must be 0 (mean objective) or a quantile in (0, 1), "
                f"got {self.tail_target}"
            )
        if self.rollout_budget < 0:
            raise ValueError(f"rollout_budget must be >= 0, got {self.rollout_budget}")
        if not self.rollout_horizon_s > 0.0:
            raise ValueError(
                f"rollout_horizon_s must be > 0, got {self.rollout_horizon_s}"
            )
        items = (
            self.app_weights.items()
            if isinstance(self.app_weights, Mapping)
            else self.app_weights
        )
        norm = tuple(sorted((str(name), float(w)) for name, w in items))
        for name, w in norm:
            if not (w > 0.0 and np.isfinite(w)):
                raise ValueError(f"app_weights[{name!r}] must be finite and > 0, got {w}")
        object.__setattr__(self, "app_weights", norm)

    def weight_vector(self, names: Sequence[str]) -> np.ndarray | None:
        """(M,) weight array aligned with ``names``, or None when unweighted
        (no app_weights set) so callers can keep the scalar fast path."""
        if not self.app_weights:
            return None
        table = dict(self.app_weights)
        return np.array([table.get(n, 1.0) for n in names], dtype=float)


@dataclasses.dataclass(frozen=True)
class AllocRequest:
    """One allocation problem instance, policy-agnostic.

    ``packed`` optionally carries an engine.PackedApps built by the caller
    (e.g. the fleet binding packs once per observation epoch); policies that
    don't use the batched engine ignore it. ``warm`` is a previous Allocation
    for the same app mix (quasi-dynamic execution); policies without warm-start
    support ignore it. ``extra`` passes policy-specific knobs (e.g.
    ``weights`` for crms_priority) without widening the shared contract.
    ``device`` names the torch device the solve runs on: None means the CUDA
    device (RuntimeError without one); pass ``"cpu"`` to run on the CPU.
    """

    apps: Sequence[App]
    caps: ServerCaps
    alpha: float = 1.4
    beta: float = 0.2
    warm: Allocation | None = None
    packed: Any = None  # engine.PackedApps | None (typed loosely: leaf module)
    options: SolverOptions = dataclasses.field(default_factory=SolverOptions)
    seed: int = 0
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    device: str | None = None

    @property
    def M(self) -> int:
        return len(self.apps)

    def lam(self) -> np.ndarray:
        return np.array([a.lam for a in self.apps], dtype=float)

    def names(self) -> tuple[str, ...]:
        return tuple(a.name for a in self.apps)


@dataclasses.dataclass
class Diagnostics:
    """Structured solve diagnostics attached to every AllocResult.

    CRMS populates all fields; baselines populate wall_clock_s (and anything
    policy-specific under ``extra``) and leave the refinement counters at 0.
    Invariant (pinned by tests): accepted_moves <= refine_iters.
    """

    wall_clock_s: float = 0.0
    warm_start: bool = False  # Algorithm 1 skipped, refinement warm-started
    cache_hit: bool = False  # quasi-dynamic driver returned the cached result
    refine_iters: int = 0  # greedy refinement iterations executed
    accepted_moves: int = 0  # refinement moves accepted (<= refine_iters)
    p1_calls: int = 0  # batched P1 solves issued
    p1_rescued_rows: int = 0  # phase-1 rows rescued by the hint fallback chain
    p1_masked_rows: int = 0  # phase-1 rows masked infeasible (no interior point)
    # fleet placement layer (crms_fleet; 0 for single-node policies)
    nodes_total: int = 0  # fleet size the placement layer planned over
    nodes_solved: int = 0  # nodes actually re-solved (== total on cold plans)
    migrations: int = 0  # app migrations applied this plan (incl. emergency)
    # graceful degradation (admission control): apps throttled or dropped by
    # the load-shedding ladder this solve — [] means everything was admitted.
    # The per-app acceptance fractions live in extra["admission"]. NEVER
    # silent: an infeasible/unstable result additionally records
    # extra["infeasible"] with the binding constraint when known.
    shed: list = dataclasses.field(default_factory=list)
    extra: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_meta(cls, meta: Mapping[str, Any]) -> "Diagnostics":
        """Lift the diagnostics dict a solver left in Allocation.meta."""
        d = meta.get("diagnostics", {})
        return cls(
            wall_clock_s=float(d.get("wall_clock_s", 0.0)),
            warm_start=bool(d.get("warm_start", False)),
            refine_iters=int(d.get("refine_iters", 0)),
            accepted_moves=int(d.get("accepted_moves", 0)),
            p1_calls=int(d.get("p1_calls", 0)),
            p1_rescued_rows=int(d.get("p1_rescued_rows", 0)),
            p1_masked_rows=int(d.get("p1_masked_rows", 0)),
            nodes_total=int(d.get("nodes_total", 0)),
            nodes_solved=int(d.get("nodes_solved", 0)),
            migrations=int(d.get("migrations", 0)),
        )


@dataclasses.dataclass
class AllocResult:
    """A policy's answer: the Allocation plus who produced it and how."""

    allocation: Allocation
    policy: str
    diagnostics: Diagnostics = dataclasses.field(default_factory=Diagnostics)

    @property
    def utility(self) -> float:
        return float(self.allocation.utility)

    @property
    def feasible(self) -> bool:
        return bool(self.allocation.feasible)

    @property
    def stable(self) -> bool:
        return bool(self.allocation.stable)

    def cached_view(self) -> "AllocResult":
        """The result the quasi-dynamic driver hands back on a cache hit:
        same allocation, diagnostics flagged as served-from-cache."""
        return AllocResult(
            allocation=self.allocation,
            policy=self.policy,
            diagnostics=dataclasses.replace(
                self.diagnostics, cache_hit=True, wall_clock_s=0.0
            ),
        )


def mean_latency_s(apps: Sequence[App], allocation: Allocation) -> float:
    """λ-weighted mean response time of an allocation (inf when unstable)."""
    lam = np.array([a.lam for a in apps], dtype=float)
    ws = allocation.ws
    if ws is None or not (np.all(np.isfinite(ws)) and allocation.stable):
        return float("inf")
    return float(np.sum(lam * ws) / np.sum(lam))


def total_power_w(allocation: Allocation) -> float:
    """Total incremental power draw of an allocation."""
    if allocation.power_w is None:
        return float("nan")
    return float(np.sum(allocation.power_w))
