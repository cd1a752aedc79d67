"""Failure injection: container crashes, stragglers, and profiling error.

The paper's CRMS assumes every allocated container is healthy and every
fitted (μ, Ws) estimate holds; edge measurement studies (arXiv 2105.04995)
report container-level failures and cold-restart churn as first-order
effects. This module is the single source for the server-side failure model
threaded through the stack (DESIGN.md §15):

* ``FailureSpec`` — a per-app container crash–repair process: exponential
  crash gaps with mean ``mtbf`` (cluster-level hazard), exponential repair
  durations with mean ``mttr``, an optional *straggler* mode
  (``straggler_frac < 1``: a failure event degrades the cluster's service
  rate to ``frac·μ`` for the episode instead of removing a container — the
  co-located-interference slowdown), and a ``profile_error`` knob that
  biases the μ the *solver* sees against the μ the *DES* uses
  (``profile_error = μ_profiled / μ_true``; the ScenarioRunner divides it
  out of the replayed service rates, so an optimistic profile is punished
  by achieved latency, not hidden by it).
* ``FailureProcess`` — the deterministic event source BOTH DES engines
  drive: crash instants and repair durations are pre-drawn from a dedicated
  CRN stream keyed ``(seed, name, FAIL_SALT)``, consumed in a fixed order
  (gap, repair, gap, repair, …) that never depends on simulation state —
  so event-vs-vector sample-path parity through crash/repair sequences is
  *structural*, and with failures off no stream is even created (arrival
  and service draws stay byte-identical).
* Repairs ride the lifecycle ramp path: a repaired container is COLD, so its
  capacity returns at ``t_crash + repair + t_cold`` using the app's own
  cold-start lag (per-app heterogeneous ``t_cold``, ``core/lifecycle.py``).
* Crashes only land on healthy containers: a crash drawn while the cluster
  has nothing up (scale-to-zero, or everything already down) is discarded —
  but its repair draw is still consumed, so the stream stays aligned across
  engines regardless of capacity history.

The drain contract: ``FleetSimulator.drain()`` halts NEW crashes (else an
MTBF-finite fleet never runs out of events) but still lands every pending
repair — queued work stranded by a crash completes once its replacement
boots, exactly like cold containers booting while the fleet drains.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Any, Mapping

from repro_torch.core.arrivals import _stream

# Dedicated CRN salt for the failure stream. Must stay distinct from the
# arrival-gap (17), MMPP-chain (43) and service (29) salts so enabling
# failures never perturbs an arrival or service draw.
FAIL_SALT = 71

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FailureSpec:
    """Failure parameters of one app cluster (or a whole fleet).

    mtbf           : mean time between failure events [s] (exponential gaps,
                     cluster-level hazard). ``inf`` (default) = no failures —
                     byte-identical to the pre-failure engines.
    mttr           : mean time to repair [s] (exponential). The repaired
                     container additionally pays the app's cold-start lag.
    straggler_frac : 1.0 (default) = failure events are hard crashes
                     (capacity −1). < 1 = straggler mode: an event degrades
                     the whole cluster's service rate to ``frac·μ`` until
                     the episode's repair lands (capacity untouched).
    profile_error  : μ_profiled / μ_true — how optimistic the solver's
                     fitted service rate is vs. what the DES simulates.
                     1.0 = perfect profile.
    """

    mtbf: float = _INF
    mttr: float = 0.0
    straggler_frac: float = 1.0
    profile_error: float = 1.0

    def __post_init__(self):
        if not (self.mtbf > 0.0):  # catches nan too
            raise ValueError(f"mtbf must be > 0 (inf = off), got {self.mtbf}")
        if not (math.isfinite(self.mttr) and self.mttr >= 0.0):
            raise ValueError(f"mttr must be finite and >= 0, got {self.mttr}")
        if not (0.0 < self.straggler_frac <= 1.0):
            raise ValueError(
                f"straggler_frac must be in (0, 1], got {self.straggler_frac}"
            )
        if not (math.isfinite(self.profile_error) and self.profile_error > 0.0):
            raise ValueError(
                f"profile_error must be finite and > 0, got {self.profile_error}"
            )
        object.__setattr__(self, "mtbf", float(self.mtbf))
        object.__setattr__(self, "mttr", float(self.mttr))
        object.__setattr__(self, "straggler_frac", float(self.straggler_frac))
        object.__setattr__(self, "profile_error", float(self.profile_error))

    @property
    def active(self) -> bool:
        """True when the crash–repair process actually fires."""
        return math.isfinite(self.mtbf)

    @property
    def crash_mode(self) -> bool:
        """Hard crashes (capacity −1) vs straggler episodes (μ → frac·μ)."""
        return self.straggler_frac >= 1.0

    def availability(self, t_cold: float = 0.0) -> float:
        """Stationary per-container availability MTBF/(MTBF + MTTR + t_cold)
        — the restart lag is part of the outage, so hedging provisions
        against it too. 1.0 when failures are off."""
        if not self.active:
            return 1.0
        return self.mtbf / (self.mtbf + self.mttr + max(float(t_cold), 0.0))

    def to_dict(self) -> dict:
        return {
            "mtbf": self.mtbf if self.active else None,  # JSON-safe inf
            "mttr": self.mttr,
            "straggler_frac": self.straggler_frac,
            "profile_error": self.profile_error,
        }


OFF = FailureSpec()

_FAILURE_KEYS = {"mtbf", "mttr", "straggler_frac", "profile_error"}


def parse_failures(spec: Any) -> FailureSpec:
    """Normalize a failure declaration: None (off), a FailureSpec, a bare
    number (mtbf), or a ``{"mtbf": ..., "mttr": ...}`` dict (``mtbf: None``
    reads as off — the JSON form of inf). Single-source validation — an
    invalid spec fails at construction, not mid-replay (the
    ``parse_lifecycle`` idiom)."""
    if spec is None:
        return OFF
    if isinstance(spec, FailureSpec):
        return spec
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return FailureSpec(mtbf=float(spec))
    if isinstance(spec, Mapping):
        unknown = set(spec) - _FAILURE_KEYS
        if unknown:
            raise ValueError(f"unknown failure keys: {sorted(unknown)}")
        mtbf = spec.get("mtbf", None)
        return FailureSpec(
            mtbf=_INF if mtbf is None else float(mtbf),
            mttr=float(spec.get("mttr", 0.0)),
            straggler_frac=float(spec.get("straggler_frac", 1.0)),
            profile_error=float(spec.get("profile_error", 1.0)),
        )
    raise ValueError(f"cannot parse failure spec from {spec!r}")


class FailureProcess:
    """Deterministic crash/repair event source for ONE cluster, driven
    identically by both DES engines.

    The draw order is fixed — at every crash instant the repair duration is
    drawn *even when the crash is discarded* (no healthy container), then
    the next crash gap — so the stream position is a pure function of
    simulated time, never of capacity history. Engines ask ``next_change()``
    for the next instant, advance the simulation exactly there, then call
    ``apply_at(t, healthy)``; the returned record tells them what to do
    (shrink/grow effective capacity, or flip the straggler μ degradation).
    """

    __slots__ = (
        "spec", "t_cold", "_rng", "slow", "outstanding", "_repairs",
        "t_crash", "gen", "n_crashes", "n_repairs", "n_discarded",
    )

    def __init__(self, spec: FailureSpec, seed: int, name: str, t0: float,
                 t_cold: float = 0.0):
        if not spec.active:
            raise ValueError("FailureProcess needs an active FailureSpec")
        self.spec = spec
        self.t_cold = float(t_cold)  # the app's own cold-start lag (lifecycle ramp)
        self._rng = _stream(seed, name, FAIL_SALT)
        self.slow = False  # straggler episode active
        self.outstanding = 0  # scheduled repairs not yet landed
        self._repairs: list[float] = []  # repair-ready instants (heap)
        self.t_crash = float(t0) + float(self._rng.exponential(spec.mtbf))
        self.gen = 0  # bumps when the schedule is superseded (event-engine aux)
        self.n_crashes = 0
        self.n_repairs = 0
        self.n_discarded = 0

    def next_change(self) -> float:
        """The next instant at which this process changes cluster state
        (inf when nothing is pending)."""
        t = self.t_crash
        if self._repairs and self._repairs[0] < t:
            t = self._repairs[0]
        return t

    def halt(self) -> None:
        """Stop NEW crashes (the drain contract); pending repairs still
        land. Bumps ``gen`` so an event engine can supersede its scheduled
        failure event."""
        self.t_crash = _INF
        self.gen += 1

    def apply_at(self, t: float, healthy: int) -> dict:
        """Consume every event due by ``t``. ``healthy`` = containers
        currently up (effective capacity) — crashes need one to land on.
        Returns ``{"d_down": int, "slow": bool, "changed": bool}``; the
        engine applies ``d_down`` to its cluster's down counter and
        re-derives the effective μ from ``slow``."""
        d_down = 0
        changed = False
        while True:
            t_r = self._repairs[0] if self._repairs else _INF
            t_next = min(t_r, self.t_crash)
            if t_next > t:
                break
            if t_r <= self.t_crash:  # repairs first on (measure-zero) ties
                heapq.heappop(self._repairs)
                self.outstanding -= 1
                self.n_repairs += 1
                if self.spec.crash_mode:
                    d_down -= 1
                else:
                    self.slow = False
                changed = True
            else:
                t_c = self.t_crash
                # ALWAYS consume the repair draw — stream alignment must not
                # depend on whether the crash lands (see module docstring)
                ready = t_c + float(self._rng.exponential(self.spec.mttr)) \
                    + self.t_cold
                if self.spec.crash_mode:
                    if healthy - d_down > 0:  # net of events applied this call
                        d_down += 1
                        self.n_crashes += 1
                        self.outstanding += 1
                        heapq.heappush(self._repairs, ready)
                        changed = True
                    else:
                        self.n_discarded += 1
                else:
                    if not self.slow and healthy > 0:
                        self.slow = True
                        self.n_crashes += 1
                        self.outstanding += 1
                        heapq.heappush(self._repairs, ready)
                        changed = True
                    else:
                        self.n_discarded += 1
                self.t_crash = t_c + float(self._rng.exponential(self.spec.mtbf))
        return {"d_down": d_down, "slow": self.slow, "changed": changed}

    def stats(self) -> dict:
        return {
            "crashes": self.n_crashes,
            "repairs": self.n_repairs,
            "discarded": self.n_discarded,
            "outstanding": self.outstanding,
        }
