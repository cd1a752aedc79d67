"""Carrying state into and out of the port as plain values.

The system has no weights: its state is the app set, the server caps and the
allocation. These helpers build the port's objects from NumPy arrays or
Python numbers (whatever produced them) and flatten an Allocation back into
arrays, so two implementations can be compared on the same instance.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.power import PowerModel
from repro_torch.core.problem import Allocation, App, ServerCaps

COUNTERS = ("refine_iters", "accepted_moves", "p1_calls", "p1_rescued_rows",
            "p1_masked_rows", "warm_start")


def apps_from_arrays(names: Sequence[str], kappa, lam, xbar, r_min, r_max, cpu_min,
                     cpu_max) -> list[App]:
    """One App per row: ``kappa`` is (M, 3), the other fields (M,)."""
    kappa = np.asarray(kappa, dtype=float).reshape(len(names), 3)
    fields = [np.asarray(v, dtype=float).reshape(len(names))
              for v in (lam, xbar, r_min, r_max, cpu_min, cpu_max)]
    return [
        App(name=str(name), lam=float(la), xbar=float(xb),
            kappa=tuple(float(k) for k in kap), r_min=float(lo), r_max=float(hi),
            cpu_min=float(cmin), cpu_max=float(cmax))
        for name, kap, la, xb, lo, hi, cmin, cmax in zip(names, kappa, *fields)
    ]


def caps_from_values(r_cpu: float, r_mem: float, p_idle: float, p_full: float) -> ServerCaps:
    return ServerCaps(r_cpu=float(r_cpu), r_mem=float(r_mem),
                      power=PowerModel(p_idle=float(p_idle), p_full=float(p_full)))


def allocation_to_arrays(alloc: Allocation) -> dict:
    """{"n", "r_cpu", "r_mem", "utility"} plus the solver's diagnostics
    counters (those it recorded) — plain NumPy/Python values."""
    out = {
        "n": np.asarray(alloc.n, dtype=int),
        "r_cpu": np.asarray(alloc.r_cpu, dtype=float),
        "r_mem": np.asarray(alloc.r_mem, dtype=float),
        "utility": float(alloc.utility),
    }
    diag = alloc.meta.get("diagnostics", {})
    out.update({k: diag[k] for k in COUNTERS if k in diag})
    return out
