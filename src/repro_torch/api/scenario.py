"""Declarative scenarios: workload traces driven through any registered policy.

A ``Scenario`` is a pure description — an initial tenant mix, server caps,
objective weights, an optional continuous λ drift, and a list of discrete
events (λ shifts, app join/leave, cap resizes) pinned to decision epochs.
``Scenario.timeline()`` expands it deterministically into per-epoch
(apps, caps) states, so every policy replays the *same* trace.

``ScenarioRunner`` drives one or more registered policies through that
timeline (each behind its own QuasiDynamicPolicy cache by default, so the
§V-B threshold semantics apply uniformly) and emits the cross-policy
latency / energy / re-plan-time document of the ``BENCH_scenarios.json``
schema. Every solve, every re-evaluation and the vector engine's replay run
on the runner's ``device`` (None: the CUDA device, RuntimeError without
one). ``validate_scenarios_doc`` is the dependency-free schema gate for such
documents.

``FleetScenario`` / ``FleetScenarioRunner`` carry the same timeline over a
fleet of nodes through the ``crms_fleet`` placement policy, with app
migrations and a per-epoch DES check of sampled nodes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Mapping, Sequence, Union

import numpy as np

from repro_torch.api.quasidynamic import QuasiDynamicPolicy
from repro_torch.api.registry import Policy, get_policy
from repro_torch.api.types import (
    AllocRequest,
    SolverOptions,
    mean_latency_s,
    total_power_w,
)
from repro_torch.core.arrivals import (
    ARRIVAL_KINDS,
    SERVICE_KINDS,
    ArrivalSpec,
    estimate_arrival,
    parse_arrival,
    read_invocation_csv,
    validate_service,
)
from repro_torch.core.failures import parse_failures
from repro_torch.core.lifecycle import parse_lifecycle
from repro_torch.core.problem import App, ServerCaps
from repro_torch.device import resolve_device


# ----------------------------------------------------------------------------
# Events — discrete changes pinned to a decision epoch
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LambdaScale:
    """Multiply base arrival rates at ``epoch``: all apps by a float, or per
    app via a {name: factor} mapping."""

    epoch: int
    factors: Union[float, Mapping[str, float]]


@dataclasses.dataclass(frozen=True)
class LambdaSet:
    """Set base arrival rates at ``epoch`` via a {name: lam} mapping."""

    epoch: int
    lam: Mapping[str, float]


@dataclasses.dataclass(frozen=True)
class AppJoin:
    """A new tenant joins the mix at ``epoch``."""

    epoch: int
    app: App


@dataclasses.dataclass(frozen=True)
class AppLeave:
    """The tenant named ``name`` leaves the mix at ``epoch``."""

    epoch: int
    name: str


@dataclasses.dataclass(frozen=True)
class CapResize:
    """The server budget changes at ``epoch`` (power model is preserved)."""

    epoch: int
    r_cpu: float
    r_mem: float


@dataclasses.dataclass(frozen=True)
class AppMigrate:
    """The tenant named ``name`` moves to fleet node ``node`` at ``epoch``.

    A no-op for single-node scenarios (the mix and caps are unchanged): the
    timeline records it in ``EpochState.migrations`` for a fleet runner."""

    epoch: int
    name: str
    node: int


@dataclasses.dataclass(frozen=True)
class ContainerCrash:
    """``k`` of ``name``'s containers crash at ``epoch`` (schema 2.5).

    A scripted, deterministic capacity loss — non-preemptive (in-flight
    requests complete) and container-granular, unlike ``CapResize`` which
    rescales the whole budget. The DES backend applies it at the epoch
    boundary via ``FleetSimulator.crash``; the crashed count is surfaced to
    policies through ``extra["failures"]["down"]``, so a failure-aware policy
    (``crms_failover``) sees the crash the epoch it happens. Capacity returns
    only via a matching ``ContainerRepair`` (or the policy re-planning around
    the loss). Independent of the scenario's stochastic ``failures`` spec."""

    epoch: int
    name: str
    k: int = 1


@dataclasses.dataclass(frozen=True)
class ContainerRepair:
    """``k`` of ``name``'s crashed containers come back at ``epoch``."""

    epoch: int
    name: str
    k: int = 1


ScenarioEvent = Union[
    LambdaScale, LambdaSet, AppJoin, AppLeave, CapResize, AppMigrate,
    ContainerCrash, ContainerRepair,
]

# Deterministic same-epoch ordering: events sharing an epoch apply in this
# kind order, ties within a kind in declaration order (the sort is stable).
# Joins first so a same-epoch LambdaSet/AppMigrate can reference the new
# tenant; leaves last so same-epoch events on the leaving tenant still
# resolve.
_EVENT_ORDER = {
    AppJoin: 0,
    AppMigrate: 1,
    CapResize: 2,
    LambdaSet: 3,
    LambdaScale: 4,
    ContainerCrash: 5,  # crash before repair: a same-epoch pair nets to zero
    ContainerRepair: 6,
    AppLeave: 7,
}


def _describe(ev: ScenarioEvent) -> str:
    if isinstance(ev, LambdaScale):
        return f"lam_scale:{ev.factors}"
    if isinstance(ev, LambdaSet):
        return f"lam_set:{dict(ev.lam)}"
    if isinstance(ev, AppJoin):
        return f"app_join:{ev.app.name}"
    if isinstance(ev, AppLeave):
        return f"app_leave:{ev.name}"
    if isinstance(ev, CapResize):
        return f"cap_resize:({ev.r_cpu},{ev.r_mem})"
    if isinstance(ev, AppMigrate):
        return f"app_migrate:{ev.name}->n{ev.node}"
    if isinstance(ev, ContainerCrash):
        return f"crash:{ev.name}x{ev.k}"
    if isinstance(ev, ContainerRepair):
        return f"repair:{ev.name}x{ev.k}"
    return repr(ev)


# ----------------------------------------------------------------------------
# Continuous λ drift (the quasidynamic_trace sinusoid, as a declarative spec)
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LambdaDrift:
    """Deterministic drifting-λ modulation: slow swing (capacity pressure)
    plus a faster per-app-phased jitter, both relative to each app's current
    base rate. ``phase_spread`` spreads the apps' swing phases around the
    circle (1.0, the default, keeps the historical out-of-phase drift;
    0.0 makes the swing common-mode — the diurnal day/night pattern)."""

    amplitude: float = 0.22
    period: float = 9.0
    jitter: float = 0.06
    jitter_period: float = 3.1
    phase_spread: float = 1.0

    def factor(self, epoch: int, i: int, m: int) -> float:
        phase = 2.0 * math.pi * i * self.phase_spread / max(m, 1)
        jitter_phase = 2.0 * math.pi * i / max(m, 1)
        swing = self.amplitude * math.sin(2.0 * math.pi * epoch / self.period + phase)
        jit = self.jitter * math.sin(
            2.0 * math.pi * epoch / self.jitter_period + 1.7 * jitter_phase
        )
        return 1.0 + swing + jit


# ----------------------------------------------------------------------------
# Scenario spec + deterministic timeline expansion
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EpochState:
    """One expanded decision epoch: the mix and caps every policy sees."""

    epoch: int
    apps: tuple[App, ...]
    caps: ServerCaps
    events: tuple[str, ...]  # human-readable descriptions of applied events
    migrations: tuple = ()  # (name, node) pairs for the fleet runner
    faults: tuple = ()  # ("crash"|"repair", name, k) for the DES backend


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    apps: tuple[App, ...]
    caps: ServerCaps
    n_epochs: int = 8
    alpha: float = 1.4
    beta: float = 0.2
    events: tuple[ScenarioEvent, ...] = ()
    drift: LambdaDrift | None = None
    options: SolverOptions = dataclasses.field(default_factory=SolverOptions)
    seed: int = 0
    # DES off-model knobs (schema 2.2): the arrival law (None = Poisson; one
    # spec for the whole fleet or a {app_name: spec} mapping) and the service
    # law, validated eagerly here with the SAME single-source checks the
    # FleetSimulator engines run (core/arrivals.py) — an invalid spec fails
    # at construction, not mid-replay.
    arrival: Any = None
    service: str = "exp"
    h2_scv: float = 4.0
    # Container lifecycle (schema 2.3): cold-start lag + initial keep-warm
    # pool, one spec for the whole fleet — None / a LifecycleSpec / a bare
    # t_cold seconds / a {"t_cold", "warm_pool"} dict, normalized to a
    # LifecycleSpec here (same eager single-source validation as arrival).
    lifecycle: Any = None
    # Stochastic failure model (schema 2.5): per-container MTBF/MTTR crash–
    # repair dynamics, straggler episodes, and the profiling-error knob —
    # None / a FailureSpec / a bare mtbf seconds / a {"mtbf", "mttr",
    # "straggler_frac", "profile_error"} dict, normalized to a FailureSpec
    # here (core/failures.py, same eager validation as arrival/lifecycle).
    # Scripted ContainerCrash/ContainerRepair events compose on top.
    failures: Any = None

    def __post_init__(self):
        validate_service(self.service, self.h2_scv)
        object.__setattr__(self, "lifecycle", parse_lifecycle(self.lifecycle))
        object.__setattr__(self, "failures", parse_failures(self.failures))
        if isinstance(self.arrival, Mapping) and "kind" not in self.arrival:
            names = {a.name for a in self.apps} | {
                ev.app.name for ev in self.events if isinstance(ev, AppJoin)
            }
            parsed = {}
            for nm, sp in self.arrival.items():
                if nm not in names:
                    raise ValueError(
                        f"arrival spec names unknown app {nm!r}; "
                        f"known: {', '.join(sorted(names))}"
                    )
                parsed[nm] = parse_arrival(sp)
            object.__setattr__(self, "arrival", parsed)
        else:
            object.__setattr__(self, "arrival", parse_arrival(self.arrival))

    def arrival_for(self, name: str) -> ArrivalSpec:
        """The (validated) arrival spec replayed for app ``name``."""
        if isinstance(self.arrival, Mapping):
            return self.arrival.get(name, ArrivalSpec())
        return self.arrival

    def arrival_doc(self):
        """JSON-safe arrival description for the scenarios doc: None when the
        whole fleet is Poisson, one spec dict, or {app_name: spec dict}."""
        if isinstance(self.arrival, Mapping):
            out = {
                nm: sp.to_dict()
                for nm, sp in self.arrival.items()
                if sp.kind != "poisson"
            }
            return out or None
        return None if self.arrival.kind == "poisson" else self.arrival.to_dict()

    def lifecycle_doc(self):
        """JSON-safe lifecycle description for the scenarios doc: None for
        the historical instant-scale-up semantics, else the spec dict."""
        return None if self.lifecycle.instant else self.lifecycle.to_dict()

    def failures_doc(self):
        """JSON-safe failure description for the scenarios doc: None for the
        historical never-fails semantics, else the spec dict. A profile-error
        -only spec (mtbf=inf, profile_error != 1) never crashes anything but
        still biases the replayed μ, so it stays visible."""
        f = self.failures
        if not f.active and f.profile_error == 1.0:
            return None
        return f.to_dict()

    @classmethod
    def from_tenant_mix(cls, name: str, M: int, **kw) -> "Scenario":
        """Build the initial mix with profiler.make_tenant_mix(M) (M a
        multiple of 4; caps scale with the tile count)."""
        from repro_torch.core.profiler import make_tenant_mix

        apps, caps, _ = make_tenant_mix(M)
        return cls(name=name, apps=tuple(apps), caps=caps, **kw)

    # ------------------------------------------------------- trace library
    @classmethod
    def burst(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "burst",
        n_epochs: int = 10,
        app: str | None = None,
        factor: float = 2.5,
        start: int | None = None,
        length: int | None = None,
        **kw,
    ) -> "Scenario":
        """Flash-crowd step: one tenant's λ jumps by ``factor`` at epoch
        ``start`` and reverts ``length`` epochs later. Default burst tenant
        is the LIGHTEST one (smallest base λ) so the step stays inside the
        feasible capacity region of a constrained operating point."""
        apps = tuple(apps)
        if app is None:
            app = min(apps, key=lambda a: a.lam).name
        start = max(1, n_epochs // 3) if start is None else start
        length = max(2, n_epochs // 3) if length is None else length
        start = min(start, n_epochs - 1)
        stop = min(start + length, n_epochs - 1)
        events = [LambdaScale(epoch=start, factors={app: factor})]
        # a revert clamped onto the step epoch would cancel the burst outright
        # (factor · 1/factor in the same epoch); short traces burst to the end
        if stop > start:
            events.append(LambdaScale(epoch=stop, factors={app: 1.0 / factor}))
        return cls(
            name=name, apps=apps, caps=caps, n_epochs=n_epochs,
            events=tuple(events), **kw,
        )

    @classmethod
    def flash_crowd(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "flash_crowd",
        n_epochs: int = 12,
        app: str | None = None,
        factor: float = 3.0,
        t_cold: float = 2.0,
        warm_pool: int = 0,
        **kw,
    ) -> "Scenario":
        """Flash crowd with slow scale-up (schema 2.3): TWO λ spikes on one
        tenant under a non-zero cold-start lag. The first spike pays full
        spin-up lag for every policy; the capacity freed when it reverts can
        be PARKED warm by a lifecycle-aware policy, so the second spike is
        the keep-warm showcase — absorbed instantly versus a second full
        ramp. Default spike tenant is the lightest one (the ``burst``
        convention: the step stays inside the feasible region)."""
        apps = tuple(apps)
        if app is None:
            app = min(apps, key=lambda a: a.lam).name
        s1 = max(1, n_epochs // 4)
        length = max(2, n_epochs // 6)
        gap = max(2, n_epochs // 6)
        s2 = min(s1 + length + gap, n_epochs - 1)
        events = [LambdaScale(epoch=s1, factors={app: factor})]
        if s1 + length < s2:
            events.append(LambdaScale(epoch=s1 + length, factors={app: 1.0 / factor}))
            events.append(LambdaScale(epoch=s2, factors={app: factor}))
            if s2 + length < n_epochs - 1:
                events.append(
                    LambdaScale(epoch=s2 + length, factors={app: 1.0 / factor})
                )
        return cls(
            name=name, apps=apps, caps=caps, n_epochs=n_epochs,
            events=tuple(events),
            lifecycle={"t_cold": float(t_cold), "warm_pool": int(warm_pool)},
            **kw,
        )

    @classmethod
    def scale_to_zero(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "scale_to_zero",
        n_epochs: int = 12,
        app: str | None = None,
        idle_frac: float = 0.05,
        start: int | None = None,
        length: int | None = None,
        t_cold: float = 2.0,
        warm_pool: int = 0,
        **kw,
    ) -> "Scenario":
        """Scale-to-zero economics (schema 2.3): one tenant's traffic
        collapses to ``idle_frac`` of its base rate mid-trace and later
        returns. Under a cold-start lag the interesting question is what to
        do with the decommissioned containers: tear them down (cheap now,
        full re-ramp on return) or park them warm (idle power now, instant
        reabsorption). Default tenant is the HEAVIEST one so the freed
        capacity — and the re-ramp — are material."""
        if not 0.0 < idle_frac < 1.0:
            raise ValueError(f"idle_frac must be in (0, 1), got {idle_frac}")
        apps = tuple(apps)
        if app is None:
            app = max(apps, key=lambda a: a.lam).name
        start = max(1, n_epochs // 3) if start is None else start
        length = max(2, n_epochs // 3) if length is None else length
        start = min(start, n_epochs - 1)
        stop = min(start + length, n_epochs - 1)
        events = [LambdaScale(epoch=start, factors={app: idle_frac})]
        if stop > start:
            events.append(LambdaScale(epoch=stop, factors={app: 1.0 / idle_frac}))
        return cls(
            name=name, apps=apps, caps=caps, n_epochs=n_epochs,
            events=tuple(events),
            lifecycle={"t_cold": float(t_cold), "warm_pool": int(warm_pool)},
            **kw,
        )

    @classmethod
    def failover(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "failover",
        n_epochs: int = 10,
        drop: float = 0.25,
        start: int | None = None,
        recovery: int | None = None,
        **kw,
    ) -> "Scenario":
        """Node failure + recovery: the server budget drops by ``drop``
        (both resources — a lost node takes its CPU and memory with it) at
        epoch ``start`` and is restored at epoch ``recovery``."""
        if not 0.0 < drop < 1.0:
            raise ValueError(f"drop must be in (0, 1), got {drop}")
        start = max(1, n_epochs // 3) if start is None else start
        recovery = min(start + max(2, n_epochs // 4), n_epochs - 1) if recovery is None else recovery
        events = (
            CapResize(
                epoch=min(start, n_epochs - 1),
                r_cpu=caps.r_cpu * (1.0 - drop),
                r_mem=caps.r_mem * (1.0 - drop),
            ),
            CapResize(epoch=recovery, r_cpu=caps.r_cpu, r_mem=caps.r_mem),
        )
        return cls(name=name, apps=tuple(apps), caps=caps, n_epochs=n_epochs, events=events, **kw)

    @classmethod
    def diurnal(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "diurnal",
        n_epochs: int = 12,
        amplitude: float = 0.25,
        jitter: float = 0.04,
        **kw,
    ) -> "Scenario":
        """Diurnal sinusoid: one common-mode day/night swing over the whole
        trace (all tenants peak together — the hardest capacity pressure),
        with a small per-app jitter on top."""
        drift = LambdaDrift(
            amplitude=amplitude,
            period=float(n_epochs),
            jitter=jitter,
            phase_spread=0.0,
        )
        return cls(name=name, apps=tuple(apps), caps=caps, n_epochs=n_epochs, drift=drift, **kw)

    @classmethod
    def priority_tenants(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        name: str = "priority",
        n_epochs: int = 10,
        priority: Mapping[str, float] | None = None,
        weight: float = 4.0,
        drift: LambdaDrift | None = None,
        **kw,
    ) -> "Scenario":
        """Priority-tenant trace: ``priority`` maps tenant names to latency
        weights (default: the heaviest tenant gets ``weight``), carried in
        ``options.app_weights`` for weight-aware policies (``crms_priority``)
        while unweighted policies replay the identical trace."""
        apps = tuple(apps)
        if priority is None:
            priority = {max(apps, key=lambda a: a.lam).name: weight}
        options = kw.pop("options", SolverOptions())
        options = dataclasses.replace(options, app_weights=dict(priority))
        if drift is None:
            drift = LambdaDrift()
        return cls(
            name=name, apps=apps, caps=caps, n_epochs=n_epochs,
            drift=drift, options=options, **kw,
        )

    @classmethod
    def from_trace(
        cls,
        apps: Sequence[App],
        caps: ServerCaps,
        *,
        trace,
        name: str = "trace",
        bin_s: float = 60.0,
        n_epochs: int | None = None,
        lam_scale: float | None = None,
        min_idc: float = 1.15,
        **kw,
    ) -> "Scenario":
        """Ingest a real request log (Azure-Functions-style per-bin invocation
        counts) into a replayable scenario: per-epoch λ re-estimation feeding
        the existing drift trigger, plus a fitted burstiness (MMPP) arrival
        spec per app driving the DES backend.

        ``trace`` is either ``{row_name: counts}`` (1-D per-bin counts, bin
        width ``bin_s`` seconds) or a path to a CSV in that shape
        (``read_invocation_csv``). Rows map to ``apps`` by app name when every
        app has a row, else by order (first M rows). The trace contributes the
        *shape* of the workload — per-epoch relative rate variation (emitted
        as ``LambdaSet`` events, so ``QuasiDynamicPolicy`` sees real drift)
        and the fitted burstiness — while each template app's ``lam`` pins
        the absolute operating point: by default every row is scaled so its
        whole-trace mean rate equals the template λ (``lam_scale`` overrides
        with one explicit factor; ``lam_scale=1.0`` replays raw trace rates).

        ``n_epochs`` defaults to one epoch per 8 bins (≥ 2). Per-app specs
        with estimated IDC ≤ ``min_idc`` stay Poisson — within counting noise
        of the paper's model, burstiness inflation would only waste servers.
        """
        apps = tuple(apps)
        if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__"):
            trace = read_invocation_csv(trace)
        rows = dict(trace)
        if not rows:
            raise ValueError("trace has no rows")
        if all(a.name in rows for a in apps):
            matched = {a.name: np.asarray(rows[a.name], dtype=float) for a in apps}
        else:
            if len(rows) < len(apps):
                raise ValueError(
                    f"trace has {len(rows)} rows for {len(apps)} apps and the "
                    "row names do not cover the app names"
                )
            matched = {
                a.name: np.asarray(c, dtype=float)
                for a, c in zip(apps, rows.values())
            }
        n_bins = min(c.shape[0] for c in matched.values())
        if n_epochs is None:
            n_epochs = max(n_bins // 8, 2)
        if n_bins < n_epochs:
            raise ValueError(
                f"trace too short: {n_bins} bins for {n_epochs} epochs"
            )
        per_epoch = n_bins // n_epochs

        base_apps = []
        arrival: dict[str, ArrivalSpec] = {}
        lam_by_epoch: list[dict[str, float]] = [dict() for _ in range(n_epochs)]
        for app in apps:
            counts = matched[app.name][: per_epoch * n_epochs]
            est = estimate_arrival(counts, bin_s)
            if est["lam"] <= 0.0:
                raise ValueError(f"trace row for app {app.name!r} is all zeros")
            scale = (
                float(lam_scale) if lam_scale is not None else app.lam / est["lam"]
            )
            if est["idc"] > min_idc and est["spec"].kind == "mmpp":
                arrival[app.name] = est["spec"]
            window = counts.reshape(n_epochs, per_epoch)
            lam_e = window.mean(axis=1) / float(bin_s) * scale
            lam_e = np.maximum(lam_e, 1e-3 * max(float(lam_e.max()), 1.0))
            base_apps.append(app.with_lam(float(lam_e[0])))
            for e in range(1, n_epochs):
                lam_by_epoch[e][app.name] = float(lam_e[e])
        events = tuple(
            LambdaSet(epoch=e, lam=lam_by_epoch[e])
            for e in range(1, n_epochs)
            if lam_by_epoch[e]
        )
        return cls(
            name=name, apps=tuple(base_apps), caps=caps, n_epochs=n_epochs,
            events=events, arrival=arrival or None, **kw,
        )

    def timeline(self) -> list[EpochState]:
        """Expand events + drift into per-epoch states. Pure and
        deterministic: every policy replays exactly this trace."""
        apps = list(self.apps)
        caps = self.caps
        base = {a.name: a.lam for a in apps}
        by_epoch: dict[int, list[ScenarioEvent]] = {}
        for ev in self.events:
            if not 0 <= ev.epoch < self.n_epochs:
                raise ValueError(
                    f"event {_describe(ev)} at epoch {ev.epoch} outside "
                    f"[0, {self.n_epochs})"
                )
            by_epoch.setdefault(ev.epoch, []).append(ev)

        out = []
        for e in range(self.n_epochs):
            applied = []
            migrations = []
            faults = []
            # deterministic same-epoch tie-break: kind order, then declaration
            # order (sorted is stable) — see _EVENT_ORDER
            for ev in sorted(by_epoch.get(e, ()), key=lambda ev: _EVENT_ORDER[type(ev)]):
                if isinstance(ev, LambdaScale):
                    if isinstance(ev.factors, Mapping):
                        for nm, f in ev.factors.items():
                            if nm not in base:
                                raise ValueError(
                                    f"{_describe(ev)} names unknown app {nm!r}"
                                )
                            base[nm] = base[nm] * float(f)
                    else:
                        for nm in base:
                            base[nm] = base[nm] * float(ev.factors)
                elif isinstance(ev, LambdaSet):
                    for nm, lam in ev.lam.items():
                        if nm not in base:
                            raise ValueError(
                                f"{_describe(ev)} names unknown app {nm!r}"
                            )
                        base[nm] = float(lam)
                elif isinstance(ev, AppJoin):
                    if any(a.name == ev.app.name for a in apps):
                        raise ValueError(f"app {ev.app.name!r} already in the mix")
                    apps.append(ev.app)
                    base[ev.app.name] = ev.app.lam
                elif isinstance(ev, AppLeave):
                    if not any(a.name == ev.name for a in apps):
                        raise ValueError(f"app {ev.name!r} not in the mix")
                    apps = [a for a in apps if a.name != ev.name]
                    base.pop(ev.name, None)
                elif isinstance(ev, CapResize):
                    caps = ServerCaps(
                        r_cpu=float(ev.r_cpu), r_mem=float(ev.r_mem), power=caps.power
                    )
                elif isinstance(ev, AppMigrate):
                    if ev.name not in base:
                        raise ValueError(f"{_describe(ev)} names unknown app {ev.name!r}")
                    migrations.append((ev.name, int(ev.node)))
                elif isinstance(ev, (ContainerCrash, ContainerRepair)):
                    if ev.name not in base:
                        raise ValueError(f"{_describe(ev)} names unknown app {ev.name!r}")
                    if ev.k < 1:
                        raise ValueError(f"{_describe(ev)} needs k >= 1")
                    kind = "crash" if isinstance(ev, ContainerCrash) else "repair"
                    faults.append((kind, ev.name, int(ev.k)))
                applied.append(_describe(ev))
            m = len(apps)
            if self.drift is not None:
                epoch_apps = tuple(
                    a.with_lam(base[a.name] * self.drift.factor(e, i, m))
                    for i, a in enumerate(apps)
                )
            else:
                epoch_apps = tuple(a.with_lam(base[a.name]) for a in apps)
            out.append(EpochState(
                e, epoch_apps, caps, tuple(applied), tuple(migrations),
                tuple(faults),
            ))
        return out


# ----------------------------------------------------------------------------
# Runner
# ----------------------------------------------------------------------------
def _num(x: float) -> float | None:
    """JSON-safe number: non-finite values become null (valid JSON has no
    Infinity literal; the schema allows number-or-null)."""
    x = float(x)
    return x if math.isfinite(x) else None


def _predicted_mean_s(apps: Sequence[App], alloc, device=None) -> float:
    """The analytic model's λ-weighted mean response prediction for this
    allocation AT THE EPOCH'S ACTUAL RATES — unlike ``mean_latency_s``, which
    reads the Ws the solver stored (stale when a cached allocation is replayed
    under drift). This is the number the DES backend's achieved latency is
    compared against: the gap between them is model error plus staleness, the
    closed-loop signal the analytic backend cannot see. μ is computed on
    ``device``."""
    from repro_torch.core.problem import service_rate
    from repro_torch.core.queueing import erlang_ws_np

    lam = np.array([a.lam for a in apps], dtype=float)
    ws = np.empty(len(apps))
    for i, app in enumerate(apps):
        n = int(alloc.n[i])
        if n < 1:
            return float("inf")
        mu = float(service_rate(app, float(alloc.r_cpu[i]), float(alloc.r_mem[i]), device))
        ws[i] = erlang_ws_np(n, app.lam, mu)
    if not np.all(np.isfinite(ws)):
        return float("inf")
    return float(np.sum(lam * ws) / np.sum(lam))


class _DesReplay:
    """Replay one policy's trace through the fleet DES: each epoch's arrivals
    run against the allocation the policy actually chose, with epoch-boundary
    reconfiguration carrying in-flight work across re-plans. ``engine``
    selects the heapq oracle ("event") or the Kiefer–Wolfowitz segment fast
    path ("vector") — epoch boundaries are exactly the segment boundaries the
    vector engine hands off at. ``lifecycle`` (schema 2.3) is the scenario's
    cold-start spec: epoch-boundary scale-ups beyond each app's warm pool
    land only after ``t_cold``; allocations carrying ``meta["keep_warm"]``
    (crms_lifecycle) retarget the per-app pools each epoch. ``failures``
    (schema 2.5) is the scenario's crash–repair spec: the simulators run the
    stochastic FailureProcess per app, scripted ContainerCrash/Repair events
    land at epoch boundaries, and allocations carrying ``meta["admission"]``
    (the load-shedding ladder) throttle each app's offered λ — the DES
    replays what an admission controller actually admits. A ``profile_error``
    e ≠ 1 divides the simulated service rate: the solver planned with μ, the
    fleet serves at μ/e — the model-error robustness axis. ``device`` is the
    vector engine's (None: the CUDA device); the event engine runs on the
    host and ignores it."""

    def __init__(
        self,
        seed: int,
        epoch_s: float,
        engine: str = "event",
        service: str = "exp",
        h2_scv: float = 4.0,
        arrival_for=None,
        lifecycle=None,
        failures=None,
        device=None,
    ):
        from repro_torch.core.des import FleetSimulator
        from repro_torch.core.failures import parse_failures as _pf

        self.failures = _pf(failures)
        self.sim = FleetSimulator(
            seed=seed, engine=engine, service=service, h2_scv=h2_scv,
            lifecycle=lifecycle, failures=self.failures, device=device,
        )
        self.device = device
        self.epoch_s = float(epoch_s)
        self._arrival_for = arrival_for  # name -> ArrivalSpec (None = Poisson)
        self._present: dict[int, list[str]] = {}  # epoch -> app names simulated
        self._live: set[str] = set()  # names currently receiving arrivals

    def apply_epoch(self, state: EpochState, alloc) -> None:
        from repro_torch.core.problem import service_rate

        names = [a.name for a in state.apps]
        warm = alloc.meta.get("keep_warm")  # per-app pool targets, app order
        admission = alloc.meta.get("admission")  # name -> accepted λ fraction
        pe = self.failures.profile_error  # solver-μ vs fleet-μ bias (>= 1e-9)
        for gone in self._live - set(names):
            self.sim.retire(gone)
        live = set()
        for i, app in enumerate(state.apps):
            mu = float(service_rate(app, float(alloc.r_cpu[i]), float(alloc.r_mem[i]),
                                    self.device))
            mu = mu / pe  # the fleet's TRUE rate; the solver saw the profile
            n = int(alloc.n[i])
            wp = int(warm[i]) if warm is not None else None
            frac = float(admission.get(app.name, 1.0)) if admission else 1.0
            lam = app.lam * frac
            if app.name in self.sim.apps():
                if frac <= 0.0:  # fully shed: no arrivals, drain what's queued
                    self.sim.configure(app.name, n_servers=n, warm_pool=wp)
                    self.sim.retire(app.name)
                    continue
                self.sim.configure(
                    app.name, lam=lam, mu=mu, n_servers=n, warm_pool=wp
                )
                self.sim.activate(app.name)  # no-op unless re-joining/re-admitted
            else:
                if frac <= 0.0:  # shed on arrival: never simulated this epoch
                    continue
                spec = self._arrival_for(app.name) if self._arrival_for else None
                self.sim.add_app(app.name, lam, mu, n, arrival=spec)
                if wp:  # pool target for a joining tenant (boots in background)
                    self.sim.configure(app.name, warm_pool=wp)
            live.add(app.name)
        self._live = live
        self._present[state.epoch] = [nm for nm in names if nm in live]
        for kind, nm, k in state.faults:  # scripted crash/repair events
            if nm in self.sim.apps():
                (self.sim.crash if kind == "crash" else self.sim.repair)(nm, k)
        self.sim.run_until((state.epoch + 1) * self.epoch_s)

    def downs(self) -> dict[str, int]:
        """Per-app crashed-container counts at the current replay instant —
        the crash notification surface forwarded to failover policies."""
        return self.sim.downs()

    def finish(self) -> None:
        self.sim.drain()

    def epoch_achieved(self, epoch: int) -> tuple[float | None, float | None, int]:
        """(mean, p95, n_completed) pooled over every app present in the
        epoch, for requests that ARRIVED inside the epoch window."""
        t0, t1 = epoch * self.epoch_s, (epoch + 1) * self.epoch_s
        chunks = [
            self.sim.responses(name, t0, t1) for name in self._present.get(epoch, [])
        ]
        resp = np.concatenate(chunks) if chunks else np.empty(0)
        if resp.size == 0:
            return None, None, 0
        return (
            float(np.mean(resp)),
            float(np.percentile(resp, 95)),
            int(resp.size),
        )


_BACKENDS = ("analytic", "des")
_DES_ENGINES = ("event", "vector")


class ScenarioRunner:
    """Drive registered policies through one scenario's timeline.

    ``quasi_dynamic=True`` (default) wraps each policy in its own
    QuasiDynamicPolicy cache, so re-plans happen only on mix/caps changes or
    λ drift past ``scenario.options.qd_threshold`` — the §V-B semantics,
    uniformly for CRMS and every baseline. Policies that manage their own
    cache (``self_caching = True``, e.g. the predictive re-planner) are
    driven directly and reset before the replay. ``extra`` carries per-policy
    request knobs, e.g. ``{"random_search": {"n_samples": 4000}}``.

    ``backend`` selects the evaluation layer:

    * ``"analytic"`` — score each epoch with the Erlang-C model the solver
      itself optimizes (fast; the historical closed-feedback loop).
    * ``"des"`` — ALSO replay each epoch's Poisson arrivals through the fleet
      discrete-event simulator against the policy's chosen allocation
      (``epoch_s`` simulated seconds per decision epoch, common-random-number
      arrivals across policies) and record the *achieved* mean/p95 latency
      next to the model's prediction, plus their relative gap per epoch.
      ``des_engine`` picks the simulator implementation: the ``"event"``
      heapq oracle or the ``"vector"`` Kiefer–Wolfowitz segment fast path
      (same CRN streams, ~20x+ the throughput — what makes long diurnal
      traces at realistic rates affordable).

    ``device`` goes into every AllocRequest the runner builds, into the DES
    replay (the vector engine scans on it) and into the μ of the predicted
    and replayed latencies. None means the CUDA device and raises
    RuntimeError without one; pass ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        scenario: Scenario,
        policies: Sequence[str | Policy],
        quasi_dynamic: bool = True,
        extra: Mapping[str, Mapping[str, Any]] | None = None,
        backend: str = "analytic",
        epoch_s: float = 60.0,
        des_engine: str = "event",
        slo_p95_s: float | None = None,
        device=None,
    ):
        resolve_device(device)  # no card and no device named: RuntimeError
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if des_engine not in _DES_ENGINES:
            raise ValueError(
                f"des_engine must be one of {_DES_ENGINES}, got {des_engine!r}"
            )
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be > 0, got {epoch_s}")
        if slo_p95_s is not None and not slo_p95_s > 0:
            raise ValueError(f"slo_p95_s must be > 0 (or None), got {slo_p95_s}")
        self.scenario = scenario
        self.policies = [get_policy(p) if isinstance(p, str) else p for p in policies]
        self.quasi_dynamic = quasi_dynamic
        self.extra = dict(extra or {})
        self.backend = backend
        self.epoch_s = float(epoch_s)
        self.des_engine = des_engine
        # schema 2.4: a p95 response-time SLO [s]. Under the DES backend every
        # policy summary then reports its achieved-p95 violation rate — the
        # fraction of measured epochs whose achieved_p95_s exceeds the SLO.
        self.slo_p95_s = None if slo_p95_s is None else float(slo_p95_s)
        self.device = device

    def _wrapped(self, policy: Policy) -> Policy:
        if getattr(policy, "self_caching", False) or not self.quasi_dynamic:
            wrapped = policy
        else:
            wrapped = QuasiDynamicPolicy(
                policy, threshold=self.scenario.options.qd_threshold
            )
        if hasattr(wrapped, "reset"):
            wrapped.reset()
        return wrapped

    def run(self) -> dict:
        sc = self.scenario
        timeline = sc.timeline()
        doc: dict = {
            "schema_version": 2,
            "backend": self.backend,
            "scenario": {
                "name": sc.name,
                "n_epochs": sc.n_epochs,
                "n_apps_initial": len(sc.apps),
                "alpha": sc.alpha,
                "beta": sc.beta,
                "caps": {"r_cpu": float(sc.caps.r_cpu), "r_mem": float(sc.caps.r_mem)},
                "events": [
                    {"epoch": ev.epoch, "event": _describe(ev)} for ev in sc.events
                ],
                "drift": dataclasses.asdict(sc.drift) if sc.drift else None,
                "quasi_dynamic": self.quasi_dynamic,
                "qd_threshold": sc.options.qd_threshold,
                "app_weights": dict(sc.options.app_weights),
                "epoch_s": self.epoch_s,
                "des_engine": self.des_engine,
                "arrival": sc.arrival_doc(),
                "service": sc.service,
                "lifecycle": sc.lifecycle_doc(),
                "failures": sc.failures_doc(),
                "slo_p95_s": self.slo_p95_s,
            },
            "policies": {},
        }
        # burstiness-aware policies (robust_crms) read the per-app peak-phase
        # rate ratios from request.extra; explicit per-policy extras win
        ratios = {}
        for state in timeline:
            for app in state.apps:
                r = sc.arrival_for(app.name).lam_hi_ratio()
                if r > 1.0:
                    ratios[app.name] = r
        for policy in self.policies:
            wrapped = self._wrapped(policy)
            replay = (
                _DesReplay(
                    seed=sc.seed,
                    epoch_s=self.epoch_s,
                    engine=self.des_engine,
                    service=sc.service,
                    h2_scv=sc.h2_scv,
                    arrival_for=sc.arrival_for,
                    lifecycle=sc.lifecycle,
                    failures=sc.failures,
                    device=self.device,
                )
                if self.backend == "des"
                else None
            )
            extra = dict(self.extra.get(policy.name, {}))
            if ratios:
                extra.setdefault("arrival_ratios", ratios)
            # lifecycle-aware policies (crms_lifecycle) read the scenario's
            # lifecycle spec and the epoch length (their re-plan gain horizon).
            # Injected only for lifecycle scenarios: baseline policies splat
            # request.extra into their kwargs and must not see foreign keys.
            if not sc.lifecycle.instant:
                extra.setdefault("lifecycle", sc.lifecycle.to_dict())
                extra.setdefault("replan_horizon_s", self.epoch_s)
            epochs = []
            failure_trace = (
                sc.failures_doc() is not None
                or any(s.faults for s in timeline)
            )
            for state in timeline:
                req_extra = extra
                down: dict[str, int] = {}
                if failure_trace:
                    # failure-aware policies (crms_failover) read the spec,
                    # the live crashed-container counts (the DES's view at
                    # the epoch boundary — the crash notification), and the
                    # repair-path cold-start lag. Injected per epoch because
                    # ``down`` evolves with the replay; only for failure
                    # scenarios so baseline kwargs stay clean.
                    down = replay.downs() if replay is not None else {}
                    req_extra = {
                        **extra,
                        "failures": {
                            "spec": sc.failures.to_dict(),
                            "down": down,
                            "t_cold": sc.lifecycle.t_cold_max,
                        },
                    }
                request = AllocRequest(
                    apps=state.apps,
                    caps=state.caps,
                    alpha=sc.alpha,
                    beta=sc.beta,
                    options=sc.options,
                    seed=sc.seed,
                    extra=req_extra,
                    device=self.device,
                )
                t0 = time.perf_counter()
                result = wrapped.allocate(request)
                dt = time.perf_counter() - t0
                alloc = result.allocation
                if replay is not None:
                    replay.apply_epoch(state, alloc)
                rec_failures = (
                    {
                        "n_down": int(sum(down.values())),
                        "shed": list(result.diagnostics.shed),
                    }
                    if failure_trace
                    else {}
                )
                epochs.append(
                    {
                        "epoch": state.epoch,
                        "M": len(state.apps),
                        "events": list(state.events),
                        "replanned": not result.diagnostics.cache_hit,
                        "wall_clock_s": dt,
                        "utility": _num(alloc.utility),
                        "mean_latency_s": _num(mean_latency_s(state.apps, alloc)),
                        "predicted_mean_s": _num(
                            _predicted_mean_s(state.apps, alloc, self.device)
                        ),
                        "achieved_mean_s": None,
                        "achieved_p95_s": None,
                        "latency_gap_rel": None,
                        "total_power_w": _num(total_power_w(alloc)),
                        "n_containers": int(np.sum(alloc.n)),
                        "feasible": bool(alloc.feasible),
                        "stable": bool(alloc.stable),
                        "warm_start": bool(result.diagnostics.warm_start),
                        "refine_iters": int(result.diagnostics.refine_iters),
                        "accepted_moves": int(result.diagnostics.accepted_moves),
                        **rec_failures,
                    }
                )
            if replay is not None:
                replay.finish()
                for rec in epochs:
                    ach, p95, _ = replay.epoch_achieved(rec["epoch"])
                    rec["achieved_mean_s"] = ach
                    rec["achieved_p95_s"] = p95
                    pred = rec["predicted_mean_s"]
                    if ach is not None and pred is not None and pred > 0:
                        rec["latency_gap_rel"] = abs(ach - pred) / pred
            replans = [r for r in epochs if r["replanned"]]
            lat = [r["mean_latency_s"] for r in epochs if r["mean_latency_s"] is not None]
            pwr = [r["total_power_w"] for r in epochs if r["total_power_w"] is not None]
            ach = [r["achieved_mean_s"] for r in epochs if r["achieved_mean_s"] is not None]
            gap = [r["latency_gap_rel"] for r in epochs if r["latency_gap_rel"] is not None]
            summary = {
                "n_epochs": len(epochs),
                "n_replans": len(replans),
                "replan_time_s_mean": (
                    float(np.mean([r["wall_clock_s"] for r in replans]))
                    if replans
                    else None
                ),
                "mean_latency_s": float(np.mean(lat)) if lat else None,
                "achieved_mean_s": float(np.mean(ach)) if ach else None,
                "mean_gap_rel": float(np.mean(gap)) if gap else None,
                "total_power_w_mean": float(np.mean(pwr)) if pwr else None,
                "all_feasible": all(r["feasible"] for r in epochs),
                "all_stable": all(r["stable"] for r in epochs),
            }
            if failure_trace:
                # graceful-degradation accounting: shedding is always visible
                summary["epochs_shed"] = int(
                    sum(1 for r in epochs if r.get("shed"))
                )
                if replay is not None:
                    summary["failure_stats"] = replay.sim.failure_stats()
            if self.slo_p95_s is not None:
                # SLO attainment (schema 2.4): rate over epochs the DES
                # actually measured — empty-window epochs carry no evidence
                # either way and are excluded rather than counted as met
                p95s = [
                    r["achieved_p95_s"] for r in epochs
                    if r["achieved_p95_s"] is not None
                ]
                summary["slo_p95_s"] = self.slo_p95_s
                summary["achieved_p95_s_mean"] = (
                    float(np.mean(p95s)) if p95s else None
                )
                summary["p95_violation_rate"] = (
                    float(np.mean([p > self.slo_p95_s for p in p95s]))
                    if p95s
                    else None
                )
            doc["policies"][policy.name] = {"epochs": epochs, "summary": summary}
        # the cross-policy comparison matrix the benchmark prints/publishes
        doc["matrix"] = {
            name: dict(p["summary"]) for name, p in doc["policies"].items()
        }
        return doc


# ----------------------------------------------------------------------------
# Fleet scenarios: multi-node traces with app migrations
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FleetScenario(Scenario):
    """A Scenario over a fleet of nodes (the ``fleet_of_fleets`` problem
    type): ``node_caps`` carries one (cpu, mem) budget per node, events may
    include ``AppMigrate``, and ``validate_nodes`` nodes are sampled per
    epoch for DES validation by the FleetScenarioRunner. The inherited
    ``caps`` field stays the nominal single-node budget (unused by the fleet
    policy but kept so the base timeline machinery — drift, λ events,
    join/leave — applies verbatim)."""

    node_caps: tuple = ()
    validate_nodes: int = 4

    @classmethod
    def from_fleet(cls, name: str, n_nodes: int, apps_per_node: int, *, seed: int = 0, **kw):
        """Build from placement.make_fleet's synthetic generator."""
        from repro_torch.core.placement import make_fleet

        apps, node_caps = make_fleet(n_nodes, apps_per_node, seed=seed)
        caps = ServerCaps(
            r_cpu=float(np.mean([c for c, _ in node_caps])),
            r_mem=float(np.mean([m for _, m in node_caps])),
        )
        return cls(
            name=name, apps=tuple(apps), caps=caps,
            node_caps=tuple(node_caps), seed=seed, **kw,
        )


class FleetScenarioRunner:
    """Drive the ``crms_fleet`` policy through a FleetScenario's timeline.

    Each epoch forwards the fleet shape and that epoch's migrations through
    ``request.extra`` and, when ``validate_nodes > 0``, replays a sampled
    subset of nodes through the DES (des.validate_placement_sample) — the
    per-epoch closed-loop check on the placement layer's Erlang-C inner
    model. The sample is drawn deterministically from the scenario seed, so
    replays validate the same nodes.

    ``device`` goes into every AllocRequest (the row solves run on it) and
    into the vector engine's replay; None means the CUDA device and raises
    RuntimeError without one. The ``"event"`` engine is host code."""

    def __init__(
        self,
        scenario: FleetScenario,
        policy: str | Policy = "crms_fleet",
        des_engine: str = "vector",
        epoch_s: float = 60.0,
        extra: Mapping[str, Any] | None = None,
        device=None,
    ):
        resolve_device(device)  # no card and no device named: RuntimeError
        if des_engine not in _DES_ENGINES:
            raise ValueError(
                f"des_engine must be one of {_DES_ENGINES}, got {des_engine!r}"
            )
        self.scenario = scenario
        self.policy = get_policy(policy) if isinstance(policy, str) else policy
        self.des_engine = des_engine
        self.epoch_s = float(epoch_s)
        self.extra = dict(extra or {})
        self.device = device

    def _sample_validation(self, planner, epoch: int) -> list[dict]:
        from repro_torch.core.des import validate_placement_sample
        from repro_torch.core.problem import service_rate

        sc = self.scenario
        k = min(int(sc.validate_nodes), planner.N)
        if k <= 0:
            return []
        rng = np.random.default_rng(sc.seed * 100003 + epoch)
        solved = np.where(planner.node_ok)[0]
        if solved.size == 0:
            return []
        nodes = rng.choice(solved, size=min(k, solved.size), replace=False)
        dev = resolve_device(self.device)
        samples = []
        for j in nodes:
            on_j = np.where(planner.assignment == j)[0]
            entries = []
            for i in on_j:
                app = planner.apps[int(i)].with_lam(float(planner.lam[i]))
                mu = float(service_rate(app, float(planner.sol_c[i]), float(planner.sol_m[i]),
                                        device=dev))
                entries.append((app.name, app.lam, mu, int(planner.n[i])))
            samples.append((int(j), entries))
        return validate_placement_sample(
            samples, horizon_s=self.epoch_s,
            seed=sc.seed * 7919 + epoch, engine=self.des_engine, device=dev,
        )

    def run(self) -> dict:
        sc = self.scenario
        driver = self.policy
        if hasattr(driver, "reset"):
            driver.reset()
        timeline = sc.timeline()
        epochs = []
        for state in timeline:
            extra = dict(self.extra)
            extra["node_caps"] = list(sc.node_caps)
            extra["migrations"] = list(state.migrations)
            request = AllocRequest(
                apps=state.apps,
                caps=state.caps,
                alpha=sc.alpha,
                beta=sc.beta,
                options=sc.options,
                seed=sc.seed,
                extra=extra,
                device=self.device,
            )
            t0 = time.perf_counter()
            result = driver.allocate(request)
            dt = time.perf_counter() - t0
            d = result.diagnostics
            validation = (
                self._sample_validation(driver._planner, state.epoch)
                if getattr(driver, "_planner", None) is not None
                else []
            )
            gaps = [v["gap_rel"] for v in validation if v["gap_rel"] is not None]
            epochs.append(
                {
                    "epoch": state.epoch,
                    "events": list(state.events),
                    "n_apps": len(state.apps),
                    "wall_clock_s": dt,
                    "utility": _num(result.allocation.utility),
                    "cold": bool(d.extra.get("cold", False)),
                    "nodes_total": int(d.nodes_total),
                    "nodes_solved": int(d.nodes_solved),
                    "migrations": int(d.migrations),
                    "nodes_failed": int(d.extra.get("nodes_failed", 0)),
                    "validated_nodes": len(validation),
                    "validation_gap_rel_mean": float(np.mean(gaps)) if gaps else None,
                    "validation": validation,
                }
            )
        gaps = [
            r["validation_gap_rel_mean"] for r in epochs
            if r["validation_gap_rel_mean"] is not None
        ]
        incr = [r for r in epochs if not r["cold"]]
        return {
            "schema_version": "fleet-1",
            "scenario": {
                "name": sc.name,
                "n_epochs": sc.n_epochs,
                "n_nodes": len(sc.node_caps),
                "n_apps_initial": len(sc.apps),
                "alpha": sc.alpha,
                "beta": sc.beta,
                "validate_nodes": sc.validate_nodes,
                "des_engine": self.des_engine,
                "epoch_s": self.epoch_s,
                "events": [
                    {"epoch": ev.epoch, "event": _describe(ev)} for ev in sc.events
                ],
            },
            "policy": self.policy.name,
            "epochs": epochs,
            "summary": {
                "n_epochs": len(epochs),
                "n_cold": sum(1 for r in epochs if r["cold"]),
                "replan_time_s_mean": (
                    float(np.mean([r["wall_clock_s"] for r in incr])) if incr else None
                ),
                "nodes_solved_mean": float(np.mean([r["nodes_solved"] for r in epochs])),
                "migrations_total": int(sum(r["migrations"] for r in epochs)),
                "validation_gap_rel_mean": float(np.mean(gaps)) if gaps else None,
                "all_nodes_ok": all(r["nodes_failed"] == 0 for r in epochs),
            },
        }


# ----------------------------------------------------------------------------
# Compact storage shape (schema 2.1): per-epoch series as parallel arrays.
# Schema 2.2 adds the scenario-level ``arrival``/``service`` law fields —
# and the validator REJECTS unknown kinds instead of silently passing them.
# Schema 2.3 adds the scenario-level ``lifecycle`` field (cold-start lag +
# keep-warm pool; null = the historical instant-scale-up semantics).
# Schema 2.4 adds the scenario-level ``slo_p95_s`` SLO and the per-policy
# summary's ``slo_p95_s``/``achieved_p95_s_mean``/``p95_violation_rate``
# attainment fields (null = no SLO configured / nothing measured).
# Schema 2.5 adds the scenario-level ``failures`` field (MTBF/MTTR crash–
# repair model; null = the historical never-fails semantics) plus, for
# failure traces, the per-epoch ``n_down``/``shed`` columns and the summary's
# ``epochs_shed``/``failure_stats`` accounting.
# ----------------------------------------------------------------------------
SCHEMA_MINOR = 5


def compact_scenarios_doc(doc: Mapping) -> dict:
    """Return a copy storing each policy's per-epoch series as compact
    parallel arrays (``epochs_columns: {field: [v0, v1, ...]}``) instead of
    one object per epoch, and stamping ``schema_minor``. The row shape made
    BENCH_scenarios.json ~5k lines of repeated keys; the column shape is the
    same data at a fraction of the size. ``validate_scenarios_doc`` accepts
    both shapes; ``expand_scenarios_doc`` is the inverse."""

    def one(sub: Mapping) -> dict:
        out = dict(sub)
        out["schema_minor"] = SCHEMA_MINOR
        pols = {}
        for name, pol in sub["policies"].items():
            p = dict(pol)
            rows = p.pop("epochs")
            # required fields first, then any extra keys the rows carry —
            # compaction must be lossless (expand is the inverse)
            keys = dict.fromkeys(_EPOCH_FIELDS)
            for rec in rows:
                keys.update(dict.fromkeys(rec))
            p["epochs_columns"] = {
                key: [rec.get(key) for rec in rows] for key in keys
            }
            pols[name] = p
        out["policies"] = pols
        return out

    if "scenarios" in doc:
        out = dict(doc)
        out["schema_minor"] = SCHEMA_MINOR
        out["scenarios"] = {k: one(v) for k, v in doc["scenarios"].items()}
        return out
    return one(doc)


def _rows_from_columns(cols: Mapping) -> list[dict]:
    n = max((len(v) for v in cols.values()), default=0)
    return [{key: cols[key][i] for key in cols} for i in range(n)]


def expand_scenarios_doc(doc: Mapping) -> dict:
    """Inverse of ``compact_scenarios_doc``: reconstruct per-epoch row dicts
    from the parallel-array shape (no-op for row-shaped documents)."""

    def one(sub: Mapping) -> dict:
        out = dict(sub)
        pols = {}
        for name, pol in sub["policies"].items():
            p = dict(pol)
            cols = p.pop("epochs_columns", None)
            if cols is not None and "epochs" not in p:
                p["epochs"] = _rows_from_columns(cols)
            pols[name] = p
        out["policies"] = pols
        return out

    if "scenarios" in doc:
        out = dict(doc)
        out["scenarios"] = {k: one(v) for k, v in doc["scenarios"].items()}
        return out
    return one(doc)


def _scalar_series(obj) -> bool:
    """True for a (possibly nested) list holding no objects — a data series
    that reads fine on one line (e.g. the per-epoch events column)."""
    if isinstance(obj, Mapping):
        return False
    if isinstance(obj, (list, tuple)):
        return all(_scalar_series(v) for v in obj)
    return True


def _as_lists(obj):
    if isinstance(obj, (list, tuple)):
        return [_as_lists(v) for v in obj]
    return obj


def dumps_scenarios_doc(doc: Mapping, indent: int = 2) -> str:
    """JSON text with object-free arrays inlined on one line. Plain
    ``json.dumps(..., indent=2)`` prints one array element per line, which
    would hand the compact column shape right back its 5k lines."""
    import json

    def render(obj, level: int) -> str:
        pad = " " * (indent * level)
        inner = " " * (indent * (level + 1))
        if isinstance(obj, Mapping):
            if not obj:
                return "{}"
            items = ",\n".join(
                f"{inner}{json.dumps(str(k))}: {render(v, level + 1)}"
                for k, v in obj.items()
            )
            return "{\n" + items + "\n" + pad + "}"
        if isinstance(obj, (list, tuple)):
            if not obj:
                return "[]"
            if _scalar_series(obj):
                return json.dumps(_as_lists(obj))
            items = ",\n".join(f"{inner}{render(v, level + 1)}" for v in obj)
            return "[\n" + items + "\n" + pad + "]"
        return json.dumps(obj)

    return render(doc, 0)


# ----------------------------------------------------------------------------
# Schema gate (dependency-free — the container has no jsonschema)
# ----------------------------------------------------------------------------
_EPOCH_FIELDS = {
    "epoch": int,
    "M": int,
    "events": list,
    "replanned": bool,
    "wall_clock_s": (int, float),
    "utility": (int, float, type(None)),
    "mean_latency_s": (int, float, type(None)),
    "predicted_mean_s": (int, float, type(None)),
    "achieved_mean_s": (int, float, type(None)),
    "achieved_p95_s": (int, float, type(None)),
    "latency_gap_rel": (int, float, type(None)),
    "total_power_w": (int, float, type(None)),
    "n_containers": int,
    "feasible": bool,
    "stable": bool,
    "warm_start": bool,
    "refine_iters": int,
    "accepted_moves": int,
}

_SUMMARY_FIELDS = {
    "n_epochs": int,
    "n_replans": int,
    "replan_time_s_mean": (int, float, type(None)),
    "mean_latency_s": (int, float, type(None)),
    "achieved_mean_s": (int, float, type(None)),
    "mean_gap_rel": (int, float, type(None)),
    "total_power_w_mean": (int, float, type(None)),
    "all_feasible": bool,
    "all_stable": bool,
}


def _need(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"BENCH_scenarios schema violation at {path}: {msg}")


def _validate_one(doc: Mapping, root: str = "$") -> None:
    """Validate one scenario document (the per-scenario value of a bundle,
    or a standalone single-scenario file)."""
    need = _need
    need(isinstance(doc, Mapping), root, "document must be an object")
    need(doc.get("schema_version") == 2, f"{root}.schema_version", "must be 2")
    if "schema_minor" in doc:
        need(
            isinstance(doc["schema_minor"], int) and not isinstance(doc["schema_minor"], bool)
            and 0 <= doc["schema_minor"] <= SCHEMA_MINOR,
            f"{root}.schema_minor",
            f"must be an int in [0, {SCHEMA_MINOR}]",
        )
    backend = doc.get("backend")
    need(backend in _BACKENDS, f"{root}.backend", f"must be one of {_BACKENDS}")
    sc = doc.get("scenario")
    need(isinstance(sc, Mapping), f"{root}.scenario", "must be an object")
    for key, typ in (
        ("name", str),
        ("n_epochs", int),
        ("n_apps_initial", int),
        ("events", list),
        ("app_weights", Mapping),
        ("epoch_s", (int, float)),
    ):
        tn = typ.__name__ if isinstance(typ, type) else str(typ)
        need(isinstance(sc.get(key), typ), f"{root}.scenario.{key}", f"must be {tn}")
    if "des_engine" in sc:  # added with the vector fast path; absent pre-2.1
        need(
            sc["des_engine"] in _DES_ENGINES,
            f"{root}.scenario.des_engine",
            f"must be one of {_DES_ENGINES}",
        )
    if sc.get("slo_p95_s") is not None:  # schema 2.4, absent/null = no SLO
        need(
            isinstance(sc["slo_p95_s"], (int, float))
            and not isinstance(sc["slo_p95_s"], bool)
            and sc["slo_p95_s"] > 0,
            f"{root}.scenario.slo_p95_s",
            "must be a positive number or null",
        )
    # schema 2.2 arrival/service law fields — optional for back-compat, but an
    # unknown kind is an ERROR, never a silent pass
    if sc.get("service") is not None:
        need(
            sc["service"] in SERVICE_KINDS,
            f"{root}.scenario.service",
            f"must be one of {SERVICE_KINDS}",
        )
    if sc.get("arrival") is not None:
        arr = sc["arrival"]
        need(
            isinstance(arr, Mapping),
            f"{root}.scenario.arrival",
            "must be an arrival-spec object or a {app: spec} mapping",
        )
        specs = {"": arr} if "kind" in arr else dict(arr)
        need(
            len(specs) > 0,
            f"{root}.scenario.arrival",
            "per-app arrival mapping must be non-empty (use null for Poisson)",
        )
        for app_name, sp in specs.items():
            at = f"{root}.scenario.arrival" + (f"[{app_name}]" if app_name else "")
            need(isinstance(sp, Mapping), at, "each arrival spec must be an object")
            need(
                sp.get("kind") in ARRIVAL_KINDS,
                f"{at}.kind",
                f"must be one of {ARRIVAL_KINDS}",
            )
            if sp.get("kind") == "mmpp":
                rates, sojourn = sp.get("rates"), sp.get("sojourn")
                need(
                    isinstance(rates, list) and isinstance(sojourn, list)
                    and len(rates) == len(sojourn) >= 2,
                    f"{at}",
                    "mmpp specs need matching rates/sojourn lists of >= 2 phases",
                )
    # schema 2.3 lifecycle field — optional (absent/null = instant scale-up),
    # but a malformed spec is an ERROR, never a silent pass
    if sc.get("lifecycle") is not None:
        lcd = sc["lifecycle"]
        at = f"{root}.scenario.lifecycle"
        need(isinstance(lcd, Mapping), at, "must be a lifecycle-spec object")
        need(
            set(lcd) <= {"t_cold", "warm_pool"},
            at,
            f"unknown lifecycle keys {sorted(set(lcd) - {'t_cold', 'warm_pool'})}",
        )
        tc = lcd.get("t_cold", 0.0)
        need(
            isinstance(tc, (int, float)) and not isinstance(tc, bool)
            and math.isfinite(tc) and tc >= 0,
            f"{at}.t_cold",
            "must be a finite number >= 0",
        )
        wp = lcd.get("warm_pool", 0)
        need(
            isinstance(wp, int) and not isinstance(wp, bool) and wp >= 0,
            f"{at}.warm_pool",
            "must be an int >= 0",
        )
    # schema 2.5 failures field — optional (absent/null = never fails), but a
    # malformed spec is an ERROR, never a silent pass
    if sc.get("failures") is not None:
        fd = sc["failures"]
        at = f"{root}.scenario.failures"
        _FKEYS = {"mtbf", "mttr", "straggler_frac", "profile_error"}
        need(isinstance(fd, Mapping), at, "must be a failure-spec object")
        need(
            set(fd) <= _FKEYS,
            at,
            f"unknown failure keys {sorted(set(fd) - _FKEYS)}",
        )
        mtbf = fd.get("mtbf")
        need(
            mtbf is None
            or (
                isinstance(mtbf, (int, float)) and not isinstance(mtbf, bool)
                and mtbf > 0
            ),
            f"{at}.mtbf",
            "must be a number > 0 or null (null/absent = failures off)",
        )
        mttr = fd.get("mttr", 0.0)
        need(
            isinstance(mttr, (int, float)) and not isinstance(mttr, bool)
            and math.isfinite(mttr) and mttr >= 0,
            f"{at}.mttr",
            "must be a finite number >= 0",
        )
        sf = fd.get("straggler_frac", 1.0)
        need(
            isinstance(sf, (int, float)) and not isinstance(sf, bool)
            and 0 < sf <= 1,
            f"{at}.straggler_frac",
            "must be a number in (0, 1]",
        )
        pe = fd.get("profile_error", 1.0)
        need(
            isinstance(pe, (int, float)) and not isinstance(pe, bool)
            and math.isfinite(pe) and pe > 0,
            f"{at}.profile_error",
            "must be a finite number > 0",
        )
    for wname, wval in sc["app_weights"].items():
        need(
            isinstance(wval, (int, float)) and wval > 0,
            f"{root}.scenario.app_weights[{wname}]",
            "weights must be positive numbers",
        )
    pols = doc.get("policies")
    need(isinstance(pols, Mapping) and len(pols) > 0, f"{root}.policies", "non-empty object")
    for name, pol in pols.items():
        base = f"{root}.policies.{name}"
        need(isinstance(pol, Mapping), base, "must be an object")
        epochs = pol.get("epochs")
        if epochs is None and isinstance(pol.get("epochs_columns"), Mapping):
            # compact shape (schema 2.1): parallel arrays, one per field
            cols = pol["epochs_columns"]
            need(
                set(cols) >= set(_EPOCH_FIELDS),
                f"{base}.epochs_columns",
                f"must include the per-epoch fields {sorted(_EPOCH_FIELDS)}",
            )
            for key, col in cols.items():
                need(
                    isinstance(col, list) and len(col) == sc["n_epochs"],
                    f"{base}.epochs_columns.{key}",
                    f"must be a list of {sc['n_epochs']} entries",
                )
            epochs = _rows_from_columns(cols)
        need(isinstance(epochs, list), f"{base}.epochs", "must be a list")
        need(
            len(epochs) == sc["n_epochs"],
            f"{base}.epochs",
            f"must have {sc['n_epochs']} entries, got {len(epochs)}",
        )
        for i, rec in enumerate(epochs):
            for key, typ in _EPOCH_FIELDS.items():
                val = rec.get(key)
                ok_type = (
                    key in rec
                    and isinstance(val, typ)
                    and not (typ is int and isinstance(val, bool))
                )
                need(
                    ok_type,
                    f"{base}.epochs[{i}].{key}",
                    f"missing or wrong type (want {typ})",
                )
            need(
                rec["accepted_moves"] <= rec["refine_iters"],
                f"{base}.epochs[{i}]",
                "accepted_moves must be <= refine_iters",
            )
            if backend == "analytic":
                for key in ("achieved_mean_s", "achieved_p95_s", "latency_gap_rel"):
                    need(
                        rec[key] is None,
                        f"{base}.epochs[{i}].{key}",
                        "must be null under the analytic backend",
                    )
            else:  # des — a null achieved is legal only for a degenerate
                # window that completed zero requests (checked per policy below)
                need(
                    (rec["achieved_mean_s"] is None) == (rec["achieved_p95_s"] is None),
                    f"{base}.epochs[{i}]",
                    "achieved_mean_s and achieved_p95_s must be null together",
                )
        if backend == "des":
            need(
                any(rec["achieved_mean_s"] is not None for rec in epochs),
                f"{base}.epochs",
                "des backend must record achieved latency in at least one epoch",
            )
        summary = pol.get("summary")
        need(isinstance(summary, Mapping), f"{base}.summary", "must be an object")
        for key, typ in _SUMMARY_FIELDS.items():
            need(
                key in summary and isinstance(summary[key], typ),
                f"{base}.summary.{key}",
                f"missing or wrong type (want {typ})",
            )
        if summary.get("p95_violation_rate") is not None:  # schema 2.4
            rate = summary["p95_violation_rate"]
            need(
                isinstance(rate, (int, float)) and not isinstance(rate, bool)
                and 0.0 <= rate <= 1.0,
                f"{base}.summary.p95_violation_rate",
                "must be a number in [0, 1] or null",
            )
            need(
                backend == "des",
                f"{base}.summary.p95_violation_rate",
                "a measured violation rate requires the des backend",
            )
    matrix = doc.get("matrix")
    need(isinstance(matrix, Mapping), f"{root}.matrix", "must be an object")
    need(
        set(matrix) == set(pols),
        f"{root}.matrix",
        "must have exactly one row per policy",
    )


def validate_scenarios_doc(doc: Mapping) -> None:
    """Validate a BENCH_scenarios.json document — either a single scenario
    run or a multi-scenario bundle ``{"schema_version": 2, "backend": ...,
    "scenarios": {name: <single-scenario doc>}}``. Raises ValueError with the
    offending path on the first violation."""
    _need(isinstance(doc, Mapping), "$", "document must be an object")
    if "scenarios" in doc:
        _need(doc.get("schema_version") == 2, "$.schema_version", "must be 2")
        _need(
            doc.get("backend") in _BACKENDS,
            "$.backend",
            f"must be one of {_BACKENDS}",
        )
        scenarios = doc["scenarios"]
        _need(
            isinstance(scenarios, Mapping) and len(scenarios) > 0,
            "$.scenarios",
            "non-empty object",
        )
        for name, sub in scenarios.items():
            _validate_one(sub, root=f"$.scenarios.{name}")
            _need(
                sub.get("backend") == doc["backend"],
                f"$.scenarios.{name}.backend",
                "must match the bundle backend",
            )
            _need(
                isinstance(sub.get("scenario"), Mapping)
                and sub["scenario"].get("name") == name,
                f"$.scenarios.{name}.scenario.name",
                "must match the bundle key",
            )
    else:
        _validate_one(doc)
