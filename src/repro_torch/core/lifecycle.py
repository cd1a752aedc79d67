"""Container lifecycle subsystem: cold starts, keep-warm pools, switching cost.

In serverless edge practice a re-plan is not free: spinning a container up
costs seconds (arXiv 2408.07536, 2105.04995), so a quasi-dynamic controller
that treats reconfiguration as instantaneous over-trades. This module is the
single source for the lifecycle model threaded through the stack
(DESIGN.md §13):

* ``LifecycleSpec`` — cold-start lag ``t_cold`` plus an optional keep-warm
  pool size, validated once and consumed by BOTH DES engines (``des.py``
  event loop and ``des_vector.py`` segment recurrence) and the scenario
  schema (2.3).
* ``plan_capacity`` — the PURE state transition both engines apply at
  ``configure()``: scale-ups beyond the warm pool land only after ``t_cold``
  (one pending ramp per cluster, superseded by the next configure), shrinks
  are immediate and PARK freed containers into the pool up to its target,
  and the pool replenishes by booting in the background. Sharing the
  transition keeps event-vs-vector CRN parity exact through mid-ramp
  reconfigs — capacity changes never touch the arrival/service draw streams.
* The switching-cost model for the ``crms_lifecycle`` policy
  (``repro/api/policies.py``): a candidate re-plan is DEPLOYED only when its
  modeled cost-rate gain over the remaining re-plan horizon exceeds the boot
  energy of the containers it must cold-start —

      (C_old − C_new) · (H − t_cold) > β · E_boot,
      E_boot = t_cold · Σ_i k_i · span · r_cpu_i / R̄cpu  [J]

  with ``k_i`` the spin-ups the warm pool cannot absorb. This DERIVES the
  quasi-dynamic threshold from first principles instead of tuning
  ``qd_threshold``: at ``t_cold = 0`` the bar is zero and the policy
  collapses to plain CRMS (deploy every fresh solve).
* Keep-warm sizing + power: warm-but-idle containers draw
  ``WARM_IDLE_FRAC`` of their active incremental power (``power.warm_power``);
  their (paused, reclaimable) memory rides a bounded overcommit allowance
  of ``WARM_MEM_FRAC`` of the budget rather than the active budget CRMS
  saturates. Pools sized as a fraction θ of the active count
  enter the P1 power term exactly as an inflated β′ = β·(1 + idle_frac·θ)
  — ΔP_i·(1 + idle_frac·θ) has the same linear-in-capacity form as Eq. (2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np

from repro_torch.core.power import EDGE_POWER, PowerModel, warm_power


@dataclasses.dataclass(frozen=True)
class LifecycleSpec:
    """Container lifecycle parameters of one cluster (or a whole fleet).

    t_cold     : seconds between requesting a cold container and it serving.
                 0 (default) reproduces the historical instant-scale-up
                 semantics byte-for-byte.
    warm_pool  : standing keep-warm reserve per app — warm-but-idle containers
                 that absorb scale-ups instantly but draw idle power. This is
                 the simulation-side INITIAL pool; policies override the
                 per-epoch target through ``configure(warm_pool=...)``.
    t_cold_app : per-app heterogeneous cold-start overrides, a sorted tuple of
                 ``(name, t_cold)`` pairs (a mapping is normalized). Apps not
                 listed use the scalar ``t_cold`` default — the scalar form
                 stays fully back-compatible. Engines resolve the per-app lag
                 at ``add_app`` via ``for_app``; repairs and ramps then take
                 the app's OWN cold-start time.
    """

    t_cold: float = 0.0
    warm_pool: int = 0
    t_cold_app: tuple = ()

    def __post_init__(self):
        if not (math.isfinite(self.t_cold) and self.t_cold >= 0.0):
            raise ValueError(f"t_cold must be finite and >= 0, got {self.t_cold}")
        if isinstance(self.warm_pool, bool) or int(self.warm_pool) != self.warm_pool:
            raise ValueError(f"warm_pool must be an int, got {self.warm_pool!r}")
        if self.warm_pool < 0:
            raise ValueError(f"warm_pool must be >= 0, got {self.warm_pool}")
        object.__setattr__(self, "t_cold", float(self.t_cold))
        object.__setattr__(self, "warm_pool", int(self.warm_pool))
        per = self.t_cold_app
        if isinstance(per, Mapping):
            per = tuple(sorted(per.items()))
        else:
            per = tuple(sorted((str(k), v) for k, v in per))
        for k, v in per:
            if not isinstance(k, str):
                raise ValueError(f"t_cold_app keys must be app names, got {k!r}")
            if not (isinstance(v, (int, float)) and not isinstance(v, bool)
                    and math.isfinite(v) and v >= 0.0):
                raise ValueError(
                    f"t_cold_app[{k!r}] must be finite and >= 0, got {v!r}"
                )
        object.__setattr__(
            self, "t_cold_app", tuple((k, float(v)) for k, v in per)
        )

    @property
    def instant(self) -> bool:
        return (
            self.t_cold == 0.0
            and self.warm_pool == 0
            and all(v == 0.0 for _, v in self.t_cold_app)
        )

    @property
    def t_cold_max(self) -> float:
        """The largest cold-start lag any app can pay under this spec."""
        return max([self.t_cold, *(v for _, v in self.t_cold_app)])

    def t_cold_for(self, name: str) -> float:
        """The app's own cold-start lag (the scalar default unless listed)."""
        for k, v in self.t_cold_app:
            if k == name:
                return v
        return self.t_cold

    def for_app(self, name: str) -> "LifecycleSpec":
        """Resolve the per-app overrides into ONE cluster's scalar spec —
        what the engines store at ``add_app``. Returns ``self`` unchanged
        when no override applies (byte-compat fast path)."""
        if not self.t_cold_app:
            return self
        t = self.t_cold_for(name)
        if t == self.t_cold:
            return LifecycleSpec(self.t_cold, self.warm_pool)
        return LifecycleSpec(t, self.warm_pool)

    def t_cold_vec(self, names: Sequence[str]) -> np.ndarray:
        """Per-app cold-start lags as a vector (policy-layer boot energy)."""
        return np.array([self.t_cold_for(nm) for nm in names], dtype=float)

    def to_dict(self) -> dict:
        d = {"t_cold": self.t_cold, "warm_pool": self.warm_pool}
        if self.t_cold_app:
            d["t_cold_app"] = {k: v for k, v in self.t_cold_app}
        return d


INSTANT = LifecycleSpec()


def parse_lifecycle(spec: Any) -> LifecycleSpec:
    """Normalize a lifecycle declaration: None (instant), a LifecycleSpec,
    a bare number (t_cold), or a ``{"t_cold": ..., "warm_pool": ...,
    "t_cold_app": {name: t}}`` dict. Single-source validation — an invalid
    spec fails at construction, not mid-replay (the ``parse_arrival``
    idiom)."""
    if spec is None:
        return INSTANT
    if isinstance(spec, LifecycleSpec):
        return spec
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return LifecycleSpec(t_cold=float(spec))
    if isinstance(spec, Mapping):
        unknown = set(spec) - {"t_cold", "warm_pool", "t_cold_app"}
        if unknown:
            raise ValueError(f"unknown lifecycle keys: {sorted(unknown)}")
        return LifecycleSpec(
            t_cold=float(spec.get("t_cold", 0.0)),
            warm_pool=spec.get("warm_pool", 0),
            t_cold_app=spec.get("t_cold_app", ()),
        )
    raise ValueError(f"cannot parse lifecycle spec from {spec!r}")


# ----------------------------------------------------------------------------
# The shared configure() transition (both DES engines)
# ----------------------------------------------------------------------------
def plan_capacity(
    now: float,
    n_now: int,
    warm_avail: int,
    warm_target: int,
    t_cold: float,
    n_target: int | None,
    warm_pool: int | None,
) -> tuple[int, int, int, tuple[float, int, int] | None]:
    """One ``configure()`` capacity/pool request as a pure state transition.

    Returns ``(n_now', warm_avail', warm_target', pending)`` where ``pending``
    is ``None`` or ``(t_ready, n_final, warm_after)`` — the single ramp that
    lands at ``now + t_cold``. Semantics (identical in both engines, so CRN
    parity is structural):

    * shrink: immediate (non-preemptive, as before); freed containers PARK
      into the warm pool up to its target (scale-to-zero economics: a
      decommissioned container is warm, not cold).
    * grow: up to ``warm_avail`` containers move pool → active instantly;
      the remainder arrives at ``now + t_cold``. ``t_cold == 0`` keeps the
      historical instant semantics exactly (no pending, pool untouched).
    * pool deficit (consumed by a grow, or a raised target): replenishes by
      booting — the same pending ramp carries ``warm_after``.
    * a configure during a ramp SUPERSEDES it: the new transition starts from
      the currently-effective state; containers still booting are discarded.
    """
    w_t = warm_target if warm_pool is None else int(warm_pool)
    if w_t < 0:
        raise ValueError(f"warm_pool must be >= 0, got {w_t}")
    n_t = n_now if n_target is None else int(n_target)
    if n_t < 0:
        raise ValueError(f"n_servers must be >= 0, got {n_t}")
    delta = n_t - n_now
    if delta > 0:
        if t_cold <= 0.0:
            n_now = n_t
        else:
            used = min(delta, warm_avail)
            warm_avail -= used
            n_now += used
    elif delta < 0:
        n_now = n_t
        warm_avail += -delta
    warm_avail = min(warm_avail, w_t)  # trimming warm containers is free
    pending = None
    if t_cold > 0.0 and (n_now < n_t or warm_avail < w_t):
        pending = (now + t_cold, n_t, w_t)
    return n_now, warm_avail, w_t, pending


def settle_pending(cl, now: float) -> bool:
    """Apply a cluster's pending ramp if it is due (idempotent). The cluster
    object needs ``n_servers`` / ``warm_avail`` / ``pending`` attributes —
    both engines' cluster classes qualify. Returns True when the effective
    server count grew (the event engine then starts queued work)."""
    p = cl.pending
    if p is None or p[0] > now:
        return False
    _, n_t, w_after = p
    cl.pending = None
    grew = n_t > cl.n_servers
    cl.n_servers = n_t
    cl.warm_avail = w_after
    return grew


# ----------------------------------------------------------------------------
# Switching-cost model (the crms_lifecycle accept rule)
# ----------------------------------------------------------------------------
def cost_rate_w(
    lam: np.ndarray,
    ws: np.ndarray | None,
    power_w: np.ndarray | None,
    alpha: float,
    beta: float,
    warm_power_w: float = 0.0,
) -> float:
    """λ-weighted cost RATE of an operating point, in the objective's units
    per second: ``Σ_i (α λ_i Ws_i + β ΔP_i) + β P_warm``. This is exactly
    Eq. (8)'s utility re-weighted by λ (utility is per-request; multiplying
    each app's term by its request rate gives cost per second), which makes
    gains integrable over a horizon. Infinite when the point is unstable —
    an unstable incumbent always loses to a stable candidate."""
    if ws is None or power_w is None or not np.all(np.isfinite(ws)):
        return float("inf")
    lam = np.asarray(lam, dtype=float)
    return float(
        alpha * np.sum(lam * np.asarray(ws, dtype=float))
        + beta * np.sum(np.asarray(power_w, dtype=float))
        + beta * float(warm_power_w)
    )


def boot_energy_j(
    spin_ups: np.ndarray,
    r_cpu: np.ndarray,
    total_cpu: float,
    t_cold: float,
    power: PowerModel = EDGE_POWER,
) -> float:
    """Boot energy of cold-starting containers [J]: each spin-up burns its
    full incremental power (Eq. 17's per-container Δp) for the whole lag.
    ``t_cold`` may be a scalar or a per-app vector (heterogeneous lags)."""
    spin = np.asarray(spin_ups, dtype=float)
    r = np.asarray(r_cpu, dtype=float)
    tc = np.asarray(t_cold, dtype=float)
    return float(power.span * np.sum(tc * spin * r) / float(total_cpu))


def switch_decision(
    cost_old_w: float,
    cost_new_w: float,
    spin_ups: np.ndarray,
    r_cpu_new: np.ndarray,
    total_cpu: float,
    t_cold: float,
    horizon_s: float,
    beta: float,
    power: PowerModel = EDGE_POWER,
) -> dict:
    """The derived quasi-dynamic threshold: deploy the candidate iff

        (C_old − C_new) · H_eff  >  β · E_boot

    where ``H_eff = H − t_cold`` when any container must cold-start (the gain
    is not realized during the ramp) and ``E_boot`` is ``boot_energy_j``.
    Returns the full decision record for diagnostics: the gain rate, the
    switching cost, the break-even gain rate (the *derived* threshold that
    replaces the tuned ``qd_threshold``), and the verdict. ``t_cold = 0``
    makes the bar exactly 0, so any fresh solve deploys — plain CRMS.
    ``t_cold`` may be a per-app vector: the horizon docks by the LONGEST lag
    among apps that actually spin up (the ramp completes when the slowest
    cold start lands)."""
    spin_arr = np.asarray(spin_ups, dtype=float)
    any_cold = bool(np.any(spin_arr > 0))
    tc = np.asarray(t_cold, dtype=float)
    if tc.ndim:
        t_dock = float(np.max(np.where(spin_arr > 0, tc, 0.0))) if any_cold else 0.0
    else:
        t_dock = float(tc)
    h_eff = max(horizon_s - t_dock, 1e-9) if any_cold else max(horizon_s, 1e-9)
    e_boot = boot_energy_j(spin_ups, r_cpu_new, total_cpu, t_cold, power)
    switch_cost = beta * e_boot
    gain_rate = cost_old_w - cost_new_w  # inf when the incumbent is unstable
    bar = switch_cost / h_eff
    accept = (not math.isfinite(cost_old_w)) or gain_rate > bar
    return {
        "accept": bool(accept),
        "gain_rate_w": gain_rate if math.isfinite(gain_rate) else None,
        "switch_cost_j": switch_cost,
        "gain_rate_bar_w": bar,  # the derived threshold
        "horizon_eff_s": h_eff,
        "spin_ups": int(np.sum(np.maximum(np.asarray(spin_ups), 0))),
    }


# Warm-pool memory allowance as a fraction of the server's memory budget.
# CRMS saturates the active memory budget BY CONSTRUCTION (Eq. 1 latency is
# decreasing in memory, and memory draws no power), so a pool that had to fit
# the leftover budget would always be empty. Warm containers are paused —
# their pages are cold and reclaimable under pressure — so they ride a
# bounded overcommit allowance instead of the active budget.
WARM_MEM_FRAC = 0.25


def auto_warm_pool(
    n: np.ndarray,
    lam_now: np.ndarray,
    lam_peak: np.ndarray,
    spec: LifecycleSpec,
    r_mem: np.ndarray,
    mem_budget: float,
    max_frac: float = 2.0,
    warm_mem_frac: float = WARM_MEM_FRAC,
) -> np.ndarray:
    """Derived keep-warm sizing: hold enough warm containers to absorb a
    return to the recently observed peak rate, ``w_i = ⌈n_i·(λ_peak/λ_now −
    1)⌉`` capped at ``max_frac·n_i`` — the serverless keep-alive heuristic
    (pool sized by recent peak concurrency) made capacity-aware: total warm
    memory is capped at ``warm_mem_frac·mem_budget`` (the paused-container
    overcommit allowance, see ``WARM_MEM_FRAC``), pools scaled back
    proportionally when they exceed it. Zero everywhere when ``t_cold == 0``:
    a free spin-up makes every warm container pure waste."""
    n = np.asarray(n, dtype=float)
    if spec.t_cold_max <= 0.0:
        return np.zeros(n.shape[0], dtype=int)
    lam_now = np.maximum(np.asarray(lam_now, dtype=float), 1e-12)
    ratio = np.maximum(np.asarray(lam_peak, dtype=float) / lam_now - 1.0, 0.0)
    w = np.ceil(n * np.minimum(ratio, max_frac)).astype(int)
    mem = np.asarray(r_mem, dtype=float)
    allowance = max(float(warm_mem_frac) * float(mem_budget), 0.0)
    pool_mem = float(np.sum(w * mem))
    if pool_mem > allowance and pool_mem > 0.0:
        w = np.floor(w * (allowance / pool_mem)).astype(int)
    return np.maximum(w, 0)


def warm_pool_power_w(
    warm: np.ndarray,
    r_cpu: np.ndarray,
    total_cpu: float,
    power: PowerModel = EDGE_POWER,
) -> float:
    """Total idle draw of the keep-warm pools [W] (power.warm_power summed)."""
    return float(
        np.sum(warm_power(np.asarray(warm, dtype=float),
                          np.asarray(r_cpu, dtype=float), total_cpu, power))
    )


def normalize_keep_warm(
    keep_warm: Any, names: Sequence[str]
) -> np.ndarray | None:
    """Normalize an explicit keep-warm request: an int (uniform pool), a
    {app: int} mapping, or a per-app sequence. Returns None for "auto"."""
    if keep_warm is None or keep_warm == "auto":
        return None
    if isinstance(keep_warm, Mapping):
        return np.array([int(keep_warm.get(nm, 0)) for nm in names], dtype=int)
    if isinstance(keep_warm, (int, np.integer)) and not isinstance(keep_warm, bool):
        return np.full(len(names), int(keep_warm), dtype=int)
    arr = np.asarray(keep_warm, dtype=int)
    if arr.shape != (len(names),):
        raise ValueError(
            f"keep_warm must be an int, mapping, 'auto', or a length-{len(names)} "
            f"sequence; got shape {arr.shape}"
        )
    return arr
