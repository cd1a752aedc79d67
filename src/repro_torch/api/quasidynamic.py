"""Quasi-dynamic execution (§V-B) as a policy decorator — plus the predictive
variant that re-plans *ahead* of the drift threshold.

``QuasiDynamicPolicy`` wraps ANY registered policy in the caching/threshold
behaviour: cache the last result, re-run the wrapped policy only when the app
mix, the caps, or the monitored arrival rates drift past the threshold, and
pass the cached allocation as the warm start (policies without warm support
simply ignore ``request.warm``).

``PredictivePolicy`` extends the same contract with a one-step λ-trend
forecast: it observes the arrival rates of consecutive decision epochs,
linearly extrapolates the next epoch's rates, and when either the *current*
or the *forecast* drift crosses the threshold it re-optimizes NOW — at the
forecast rates. The returned allocation is always re-evaluated at the actual
current rates (on ``request.device``), so recorded utility/latency stay
honest.

Both are Policies themselves (names ``qd:<inner>`` / ``predictive:<inner>``),
stateful across calls; ``reset()`` drops the cache for a fresh trace replay,
and the ``self_caching`` marker tells the ScenarioRunner not to stack its own
QuasiDynamicPolicy on top.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.registry import Policy, get_policy
from repro_torch.api.types import AllocRequest, AllocResult


class QuasiDynamicPolicy:
    """Caching/threshold decorator over any allocation policy.

    ``threshold``: relative λ-drift that triggers re-optimization; when None,
    each request's ``options.qd_threshold`` applies.
    """

    self_caching = True  # the ScenarioRunner must not stack another QD cache

    def __init__(self, policy: str | Policy, threshold: float | None = None):
        self.policy: Policy = get_policy(policy) if isinstance(policy, str) else policy
        self.threshold = threshold
        self._names: tuple[str, ...] | None = None
        self._lam: np.ndarray | None = None
        self._caps_key: tuple[float, float] | None = None
        self._result: AllocResult | None = None
        self.reoptimizations = 0

    @property
    def name(self) -> str:
        return f"qd:{self.policy.name}"

    def _threshold_for(self, request: AllocRequest) -> float:
        return self.threshold if self.threshold is not None else request.options.qd_threshold

    @staticmethod
    def _caps_key_of(request: AllocRequest) -> tuple[float, float]:
        return (float(request.caps.r_cpu), float(request.caps.r_mem))

    def should_reoptimize(self, request: AllocRequest) -> bool:
        """True when the cached result is missing or invalidated: the app mix
        changed, the caps were resized, or λ drifted past the threshold."""
        if self._result is None:
            return True
        if request.names() != self._names or self._caps_key_of(request) != self._caps_key:
            return True
        drift = np.abs(request.lam() - self._lam) / np.maximum(self._lam, 1e-9)
        return bool(np.any(drift > self._threshold_for(request)))

    def allocate(self, request: AllocRequest) -> AllocResult:
        if not self.should_reoptimize(request):
            return self._result.cached_view()
        names = request.names()
        # warm-start only an unchanged mix under unchanged caps; an explicit
        # warm on the request wins
        warm = request.warm
        if (
            warm is None
            and self._result is not None
            and names == self._names
            and self._caps_key_of(request) == self._caps_key
        ):
            warm = self._result.allocation
        result = self.policy.allocate(dataclasses.replace(request, warm=warm))
        self._result = result
        self._names = names
        self._lam = request.lam()
        self._caps_key = self._caps_key_of(request)
        self.reoptimizations += 1
        return result

    def reset(self) -> None:
        """Drop the cached state (fresh trace replay)."""
        self._names = None
        self._lam = None
        self._caps_key = None
        self._result = None
        self.reoptimizations = 0


class PredictivePolicy:
    """Predictive re-planner: quasi-dynamic caching with a one-step λ-trend
    forecast (ROADMAP: "a predictive re-planner ahead of the drift threshold").

    Per decision epoch it observes λ_t and extrapolates

        λ̂_{t+1} = λ_t + lookahead · (λ_t − λ_{t−1})        (clamped > 0)

    and re-optimizes when the cached solve's rates have drifted past the
    threshold relative to EITHER λ_t (the reactive §V-B trigger) or λ̂_{t+1}
    (the predictive trigger — the drift that is about to happen). The solve
    itself runs at per-app max(λ_t, λ̂_{t+1}) — capacity is provisioned for
    the larger of the present and predicted load, so a rising trend is met
    ahead of time while a falling forecast can never under-provision the
    present. The result handed back is re-evaluated at the actual current
    apps so utility/ws/feasibility describe the real epoch, not the
    forecast; if even that view is infeasible/unstable while the plain
    reactive solve would not be, the policy falls back to the reactive solve.

    ``lookahead`` scales the extrapolation (1.0 = one full epoch ahead,
    0.0 = degenerate to reactive QuasiDynamicPolicy behaviour with an
    at-current-rates solve).
    """

    self_caching = True

    def __init__(
        self,
        policy: str | Policy,
        threshold: float | None = None,
        lookahead: float = 1.0,
        name: str | None = None,
    ):
        self.policy: Policy = get_policy(policy) if isinstance(policy, str) else policy
        self.threshold = threshold
        self.lookahead = float(lookahead)
        self._name = name
        self._names: tuple[str, ...] | None = None
        self._caps_key: tuple[float, float] | None = None
        self._lam_prev: np.ndarray | None = None  # λ observed on the previous call
        self._lam_solved: np.ndarray | None = None  # λ the cached solve targeted
        self._result: AllocResult | None = None
        self.reoptimizations = 0

    @property
    def name(self) -> str:
        return self._name if self._name is not None else f"predictive:{self.policy.name}"

    def _threshold_for(self, request: AllocRequest) -> float:
        return self.threshold if self.threshold is not None else request.options.qd_threshold

    def _forecast(self, lam: np.ndarray, thr: float) -> np.ndarray:
        if self._lam_prev is None or self._lam_prev.shape != lam.shape:
            return lam
        ahead = lam + self.lookahead * (lam - self._lam_prev)
        # bound the extrapolation to ±2·threshold per app: a discrete jump
        # (burst step, app join) would otherwise double itself into a forecast
        # far outside the capacity region the scenario can actually reach
        bound = 2.0 * thr
        ahead = np.clip(ahead, lam * (1.0 - bound), lam * (1.0 + bound))
        return np.maximum(ahead, 1e-6)

    def allocate(self, request: AllocRequest) -> AllocResult:
        from repro_torch.core.problem import evaluate  # lazy: keep api importable sans solver cost

        lam = request.lam()
        names = request.names()
        caps_key = (float(request.caps.r_cpu), float(request.caps.r_mem))
        mix_changed = names != self._names or caps_key != self._caps_key
        thr = self._threshold_for(request)
        forecast = lam if mix_changed else self._forecast(lam, thr)

        replan = mix_changed or self._result is None
        if not replan:
            ref = np.maximum(self._lam_solved, 1e-9)
            drift_now = np.max(np.abs(lam - self._lam_solved) / ref)
            drift_ahead = np.max(np.abs(forecast - self._lam_solved) / ref)
            replan = bool(drift_now > thr or drift_ahead > thr)

        if replan:
            warm = request.warm
            if warm is None and self._result is not None and not mix_changed:
                warm = self._result.allocation
            # provision for the larger of the present and predicted load
            solve_rates = np.maximum(lam, forecast)
            rates_solved = solve_rates
            predictive_solve = not mix_changed and bool(np.any(solve_rates > lam))
            solve_apps = (
                tuple(a.with_lam(float(f)) for a, f in zip(request.apps, solve_rates))
                if predictive_solve
                else request.apps
            )
            inner = self.policy.allocate(
                dataclasses.replace(request, apps=solve_apps, warm=warm)
            )
            alloc = inner.allocation
            # honest view: score the forecast-sized allocation at the ACTUAL rates
            actual = evaluate(
                request.apps, alloc.n, alloc.r_cpu, alloc.r_mem,
                request.caps, request.alpha, request.beta,
                device=request.device,
            )
            if predictive_solve and not (
                (inner.feasible and inner.stable)
                and (actual.feasible and actual.stable)
            ):
                # the forecast points outside the feasible capacity region —
                # fall back to the reactive solve at the observed rates
                forecast = lam
                rates_solved = lam
                inner = self.policy.allocate(
                    dataclasses.replace(request, apps=request.apps, warm=warm)
                )
                alloc = inner.allocation
                actual = evaluate(
                    request.apps, alloc.n, alloc.r_cpu, alloc.r_mem,
                    request.caps, request.alpha, request.beta,
                    device=request.device,
                )
            actual.meta.update(alloc.meta)
            actual.meta["lam_forecast"] = [float(f) for f in forecast]
            diag = dataclasses.replace(inner.diagnostics)
            diag.extra = dict(inner.diagnostics.extra, predictive=True)
            result = AllocResult(allocation=actual, policy=self.name, diagnostics=diag)
            self._result = result
            self._lam_solved = np.asarray(rates_solved, dtype=float)
            self._names = names
            self._caps_key = caps_key
            self.reoptimizations += 1
        else:
            result = self._result.cached_view()
        self._lam_prev = lam
        return result

    def reset(self) -> None:
        """Drop the cached state and the observed λ history."""
        self._names = None
        self._caps_key = None
        self._lam_prev = None
        self._lam_solved = None
        self._result = None
        self.reoptimizations = 0
