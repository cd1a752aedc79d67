"""Policy registry: pluggable allocators behind one callable contract.

Every allocator is registered under a short name and exposes
``allocate(request: AllocRequest) -> AllocResult``, so callers look
allocators up by name instead of importing their individual signatures.

    from repro_torch.api import AllocRequest, allocate, list_policies
    result = allocate("crms", AllocRequest(apps, caps, alpha=1.4, beta=0.2))

Built-in policies (``crms``, ``crms_priority``, ``crms_p95`` and the
robust, lifecycle, shedding, failover and predictive variants) live in
``repro_torch.api.policies`` and are registered lazily on first lookup, so
importing the contract types never drags in the solvers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

from repro_torch.api.types import AllocRequest, AllocResult


@runtime_checkable
class Policy(Protocol):
    """The one contract every allocation policy implements."""

    name: str

    def allocate(self, request: AllocRequest) -> AllocResult: ...


@dataclasses.dataclass(frozen=True)
class FunctionPolicy:
    """Adapter wrapping a plain ``fn(request) -> AllocResult`` as a Policy."""

    name: str
    fn: Callable[[AllocRequest], AllocResult]

    def allocate(self, request: AllocRequest) -> AllocResult:
        result = self.fn(request)
        if result.policy != self.name:
            result = dataclasses.replace(result, policy=self.name)
        return result


_REGISTRY: dict[str, Policy] = {}
_BUILTINS_STATE = "unloaded"  # -> "loading" -> "loaded"


def register_policy(name: str, *, overwrite: bool = False):
    """Decorator registering a Policy object or a bare request->result
    function under ``name``. Returns the decorated object unchanged."""

    def deco(obj):
        # load the built-ins first so a collision with a builtin name is
        # caught HERE, at the user's registration site — not later inside a
        # deferred builtins import that would leave the registry half-filled.
        # While the builtins module itself is loading, re-registration is
        # allowed so a retried import after a failure stays idempotent.
        _ensure_builtins()
        if name in _REGISTRY and not (overwrite or _BUILTINS_STATE == "loading"):
            raise ValueError(f"policy {name!r} already registered")
        policy = obj if hasattr(obj, "allocate") else FunctionPolicy(name, obj)
        _REGISTRY[name] = policy
        return obj

    return deco


def _ensure_builtins() -> None:
    global _BUILTINS_STATE
    if _BUILTINS_STATE != "unloaded":
        return  # loaded, or re-entered while policies.py is mid-import
    _BUILTINS_STATE = "loading"
    try:
        import repro_torch.api.policies  # noqa: F401 — registers the built-ins
    except BaseException:
        _BUILTINS_STATE = "unloaded"  # failed imports may be retried
        raise
    _BUILTINS_STATE = "loaded"


def get_policy(name: str) -> Policy:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown policy {name!r}; registered: {', '.join(sorted(_REGISTRY))}"
        ) from None


def list_policies() -> list[str]:
    _ensure_builtins()
    return sorted(_REGISTRY)


def allocate(policy: str | Policy, request: AllocRequest) -> AllocResult:
    """One-call convenience: resolve ``policy`` (by name if a string) and run
    it on ``request``."""
    p = get_policy(policy) if isinstance(policy, str) else policy
    return p.allocate(request)
