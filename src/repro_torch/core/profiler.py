"""Measurement-driven profiling (paper §III).

The paper profiles four PaddlePaddle apps in Docker containers, sweeping
--cpus / -m and recording mean latency. We reproduce that pipeline with a
simulated testbed: each app has ground-truth Eq.(1)-shaped latency surfaces
(CPU sensitivity SE_ResNeXt > ResNet_v2 > MobileNet_v2 > SSD_MobileNet_v1;
OOM floors r_min = {0.2, 0.2, 0.15, 0.33} GB, saturation r_max = {0.4, 0.4,
0.35, 0.7} GB as in §VI). Measurements = ground truth + multiplicative
measurement noise drawn from ``np.random.default_rng``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.problem import App, ServerCaps

# Ground-truth constants (d in ms, cpu in cores, mem in GB).
PAPER_APPS_TRUE = {
    "ResNet_v2": dict(kappa=(96.0, 1.1, 0.90), r_min=0.20, r_max=0.40),
    "SE_ResNeXt": dict(kappa=(130.0, 0.9, 1.20), r_min=0.20, r_max=0.40),
    "MobileNet_v2": dict(kappa=(24.0, 1.6, 0.45), r_min=0.15, r_max=0.35),
    "SSD_MobileNet_v1": dict(kappa=(56.0, 2.8, 1.40), r_min=0.33, r_max=0.70),
}


@dataclasses.dataclass
class ProfileData:
    app_name: str
    cpu: np.ndarray
    mem: np.ndarray
    latency_ms: np.ndarray
    true_kappa: tuple


def true_latency(name: str, cpu, mem) -> np.ndarray:
    """Eq. (1) at the app's ground-truth κ (NumPy float64)."""
    k1, k2, k3 = PAPER_APPS_TRUE[name]["kappa"]
    cpu, mem = np.asarray(cpu), np.asarray(mem)
    return k1 / (1.0 - np.exp(-k2 * cpu)) + np.exp(k3 / mem)


def profile_app(
    name: str,
    seed: int = 0,
    noise_rel: float = 0.02,
    n_repeats: int = 5,
    cpu_grid: np.ndarray | None = None,
    mem_grid: np.ndarray | None = None,
) -> ProfileData:
    """Paper protocol (§III-B): two sweeps — vary CPU at ample memory, vary
    memory at ample CPU — plus a coarse joint grid (Fig. 2's surface data).
    Each point is the mean of ``n_repeats`` noisy runs."""
    spec = PAPER_APPS_TRUE[name]
    rng = np.random.default_rng(seed)
    cpu_grid = cpu_grid if cpu_grid is not None else np.linspace(0.25, 4.0, 12)
    mem_grid = mem_grid if mem_grid is not None else np.linspace(spec["r_min"], spec["r_max"], 10)

    cpus, mems = [], []
    # sweep 1: CPU varies, memory ample (r_max)
    cpus += list(cpu_grid)
    mems += [spec["r_max"]] * len(cpu_grid)
    # sweep 2: memory varies, CPU ample (4 cores)
    cpus += [4.0] * len(mem_grid)
    mems += list(mem_grid)
    # joint grid for surface fitting
    for c in cpu_grid[::3]:
        for m in mem_grid[::3]:
            cpus.append(c)
            mems.append(m)

    cpus = np.asarray(cpus)
    mems = np.asarray(mems)
    true = true_latency(name, cpus, mems)
    runs = true[None, :] * (1.0 + noise_rel * rng.standard_normal((n_repeats, len(true))))
    measured = runs.mean(axis=0)
    return ProfileData(name, cpus, mems, measured, spec["kappa"])


def profile_all(seed: int = 0, **kw) -> dict[str, ProfileData]:
    return {name: profile_app(name, seed=seed + i, **kw) for i, name in enumerate(PAPER_APPS_TRUE)}


def make_paper_apps(
    lam: Sequence[float] = (6.0, 6.0, 6.0, 6.0),
    xbar: Sequence[float] = (5.0, 5.0, 5.0, 5.0),
    fitted: bool = True,
    seed: int = 0,
    device=None,
) -> list[App]:
    """The four §VI applications. ``fitted=True`` runs the full §III pipeline
    (profile -> NLLS fit of Eq. 1 on ``device``) and uses the *fitted* κ's, as
    the paper does; ``fitted=False`` uses ground truth."""
    apps = []
    if fitted:
        from repro_torch.core.perf_model import fit_family

        profiles = profile_all(seed=seed)
    for i, (name, spec) in enumerate(PAPER_APPS_TRUE.items()):
        if fitted:
            p = profiles[name]
            fr = fit_family("eq1", p.cpu, p.mem, p.latency_ms, n_starts=12, seed=seed + i,
                            device=device)
            kappa = tuple(float(v) for v in fr.params)
        else:
            kappa = spec["kappa"]
        apps.append(
            App(
                name=name,
                lam=float(lam[i]),
                xbar=float(xbar[i]),
                kappa=kappa,
                r_min=spec["r_min"],
                r_max=spec["r_max"],
                cpu_min=0.1,
                cpu_max=8.0,
            )
        )
    return apps


def make_tenant_mix(M: int, lam: Sequence[float] = (8.0, 7.0, 10.0, 15.0)):
    """An M-app heterogeneous tenant mix for solver scaling work (M a multiple
    of 4): the four §VI apps tiled with cycled λ perturbation factors, plus
    server caps and a representative constrained refinement state n0, both
    scaled with the tile count. Returns (apps, caps, n0)."""
    if M % 4 != 0 or M < 4:
        raise ValueError(f"M must be a positive multiple of 4, got {M}")
    base = make_paper_apps(lam=lam, fitted=False)
    factors = (1.0, 1.0, 1.0, 1.0, 0.75, 1.2, 0.6, 0.5, 0.9, 1.1, 0.8, 0.65)
    apps = []
    for t in range(M // 4):
        for j, a in enumerate(base):
            i = t * 4 + j
            f = factors[i % len(factors)]
            name = a.name if t == 0 else f"{a.name}-{t}"
            apps.append(dataclasses.replace(a, name=name, lam=a.lam * f))
    reps = M // 4
    caps = ServerCaps(r_cpu=30.0 * reps, r_mem=10.0 * reps)
    n0 = np.tile([7, 8, 3, 7], reps)
    return apps, caps, n0.astype(int)
