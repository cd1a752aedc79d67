"""Incremental power model (paper §IV-A, Eqs. 2-3).

Power is linear in the *allocated CPU-capacity fraction* — the control knob the
container runtime exposes — not in frequency. Edge defaults follow the paper's
i7-9700 testbed; only the span (full minus idle) enters the objective.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PowerModel:
    p_idle: float  # W, whole server
    p_full: float  # W at the reference full-load state

    @property
    def span(self) -> float:
        return self.p_full - self.p_idle


# Paper testbed: Intel i7-9700 edge server (8 cores).
EDGE_POWER = PowerModel(p_idle=40.0, p_full=190.0)


def cpu_fraction(n_containers, r_cpu, total_cpu):
    """Eq. (3): U_i = N_i r_i / R̄."""
    return n_containers * r_cpu / total_cpu


def delta_power(n_containers, r_cpu, total_cpu, power: PowerModel = EDGE_POWER):
    """Eq. (2): ΔP_i = (P_full - P_idle) U_i  [W]."""
    return power.span * cpu_fraction(n_containers, r_cpu, total_cpu)


def delta_power_per_container(r_cpu, total_cpu, power: PowerModel = EDGE_POWER):
    """Eq. (17): Δp_i for a single container."""
    return power.span * r_cpu / total_cpu


# A warm-but-idle container (keep-warm pool, core/lifecycle.py) holds its CPU
# quota and memory but serves nothing: it draws this fraction of the active
# container's incremental power (periodic keep-alive + resident state; the
# serverless-edge measurements behind arXiv 2105.04995 put idle-warm draw
# well below active draw but far from zero).
WARM_IDLE_FRAC = 0.15


def warm_power(
    n_warm,
    r_cpu,
    total_cpu,
    power: PowerModel = EDGE_POWER,
    idle_frac: float = WARM_IDLE_FRAC,
):
    """Incremental power of warm-but-idle containers [W]: the keep-warm pool
    term of the lifecycle-aware objective — same linear-in-capacity form as
    Eq. (2) scaled by ``idle_frac``. Pools sized as a fraction θ of the
    active count therefore enter P1 exactly as an inflated β′ =
    β·(1 + idle_frac·θ) on the existing ΔP term (DESIGN.md §13)."""
    return idle_frac * power.span * n_warm * r_cpu / total_cpu
