"""Quasi-dynamic execution (§V-B) as a policy decorator.

``QuasiDynamicPolicy`` wraps ANY registered policy in the caching/threshold
behaviour: cache the last result, re-run the wrapped policy only when the app
mix, the caps, or the monitored arrival rates drift past the threshold, and
pass the cached allocation as the warm start (policies without warm support
simply ignore ``request.warm``).

It is a Policy itself (name ``qd:<inner>``), stateful across calls;
``reset()`` drops the cache for a fresh trace replay.
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

    self_caching = True  # a scenario runner must not stack another cache

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
