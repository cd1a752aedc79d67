"""TPU-fleet binding of the paper's technique (DESIGN.md §3).

Maps the container abstraction onto a multi-tenant TPU pod:

    application  -> a served model workload (one of the assigned architectures)
    container    -> a model-sharded replica group (sub-mesh of chips)
    r_cpu        -> chips per replica group              [chips]
    r_mem        -> HBM budget per replica group         [GB] (KV-cache slots)
    d(c, m)      -> per-request latency from the roofline-derived step model

The latency "measurements" come from a roofline cost model of the pod: for a
replica of ``c`` chips serving batch ``b``,

    t_step(c) = FLOPs/(c·PEAK) + BYTES/(c·HBM_BW) + COLL(c)/LINK_BW

and a request of x̄ decode-steps completes in d = t_step·x̄/b(m), where
b(m) = (m − params_bytes) / kv_bytes_per_seq is the batch the HBM budget can
hold. d is positive, decreasing and convex in both c and m on the feasible
box — the same curve family the paper profiles, so the entire CRMS machinery
(fit -> SP1/SP2 -> P1 -> greedy) applies unchanged.

The latency model, the bounds, the profiling draws (``default_rng(seed)``)
and the roofline JSON reader are NumPy, bit for bit with
``repro/core/fleet.py``. ``build_fleet_apps`` fits Eq. (1) per architecture
through ``perf_model.fit_family`` on ``device`` (None: the CUDA device) and
returns ``App`` instances with chips/HBM-GB as the resource units;
``build_fleet_engine`` / ``fleet_allocator`` pack them and wire the
quasi-dynamic CRMS allocator to the same device.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence

import numpy as np

from repro_torch.core.perf_model import fit_family
from repro_torch.core.power import TPU_V5E_CHIP_POWER, PowerModel
from repro_torch.core.problem import App, ServerCaps

# The modelled pod's latency-model inputs: TPU v5e per-chip figures, copied
# from repro/core/fleet.py (DESIGN.md §3). The fit and the plan depend on
# them; they describe the pod being planned, not the device this code runs on.
PEAK_FLOPS = 197e12  # bf16 / chip
HBM_BW = 819e9  # B/s / chip
LINK_BW = 50e9  # B/s / link
HBM_PER_CHIP_GB = 16.0


@dataclasses.dataclass(frozen=True)
class WorkloadCost:
    """Per-decode-step cost of one architecture (from dry-run cost analysis,
    normalized to ONE sequence; see benchmarks/roofline_report.py)."""

    name: str
    flops_per_tok: float  # FLOPs per generated token per sequence (2·N_active)
    bytes_per_tok: float  # HBM bytes touched per step per seq (params read amortized over batch handled separately)
    params_bytes: float  # total parameter bytes (sharded across the replica)
    kv_bytes_per_seq: float  # KV/state cache bytes per sequence at the serving seq_len
    coll_bytes_per_tok: float  # collective bytes per token per step
    lam: float = 2.0  # request arrival rate [req/s]
    xbar_tokens: float = 256.0  # decode tokens per request


def step_latency_ms(w: WorkloadCost, chips, batch):
    """Roofline step model for a replica of ``chips`` chips at batch ``batch``."""
    chips = np.asarray(chips, dtype=float)
    batch = np.asarray(batch, dtype=float)
    flops = w.flops_per_tok * batch
    # params are re-read once per step regardless of batch; activation traffic
    # (bytes_per_tok, which excludes KV by construction) and the KV read each
    # scale with batch — KV is counted exactly once here
    bytes_ = w.params_bytes + (w.bytes_per_tok + w.kv_bytes_per_seq) * batch
    coll = w.coll_bytes_per_tok * batch + 2.0 * np.log2(np.maximum(chips, 2.0)) * 1e4
    t = flops / (chips * PEAK_FLOPS) + bytes_ / (chips * HBM_BW) + coll / (chips * LINK_BW)
    return t * 1e3  # ms


def request_latency_ms(w: WorkloadCost, chips, hbm_gb):
    """d(c, m): per-request latency when the replica's HBM budget m bounds the
    concurrent batch. Decreasing + convex in both resources."""
    chips = np.asarray(chips, dtype=float)
    hbm = np.asarray(hbm_gb, dtype=float) * 1e9
    slots = np.maximum((hbm - w.params_bytes) / w.kv_bytes_per_seq, 1.0)
    return step_latency_ms(w, chips, slots) * w.xbar_tokens / slots


def hbm_bounds_gb(w: WorkloadCost, max_batch: float = 256.0):
    """(r_min, r_max): min = params + 1 KV slot (the 'OOM floor'); max = the
    batch where extra slots stop helping (saturation, paper §III-C)."""
    r_min = (w.params_bytes + 1.5 * w.kv_bytes_per_seq) / 1e9
    r_max = (w.params_bytes + max_batch * w.kv_bytes_per_seq) / 1e9
    return r_min, r_max


def profile_workload(w: WorkloadCost, chips_grid=None, seed: int = 0, noise_rel: float = 0.01):
    """§III profiling protocol against the roofline cost model."""
    rng = np.random.default_rng(seed)
    r_min, r_max = hbm_bounds_gb(w)
    chips_grid = chips_grid if chips_grid is not None else np.array([1, 2, 4, 8, 16, 32, 64])
    hbm_grid = np.linspace(r_min, r_max, 8)
    cs, ms = [], []
    cs += list(chips_grid)
    ms += [r_max] * len(chips_grid)
    cs += [float(chips_grid[-1])] * len(hbm_grid)
    ms += list(hbm_grid)
    for c in chips_grid[::2]:
        for m in hbm_grid[::3]:
            cs.append(float(c))
            ms.append(float(m))
    cs, ms = np.asarray(cs, float), np.asarray(ms, float)
    d = request_latency_ms(w, cs, ms)
    d = d * (1.0 + noise_rel * rng.standard_normal(d.shape))
    return cs, ms, d


def build_fleet_apps(
    workloads: Sequence[WorkloadCost],
    seed: int = 0,
    device=None,
) -> list[App]:
    """Fit Eq. (1) per workload over (chips, HBM-GB) on ``device`` and return
    CRMS apps."""
    apps = []
    for i, w in enumerate(workloads):
        cs, ms, d = profile_workload(w, seed=seed + i)
        fr = fit_family("eq1", cs, ms, d, n_starts=12, seed=seed + i, device=device)
        r_min, r_max = hbm_bounds_gb(w)
        apps.append(
            App(
                name=w.name,
                lam=w.lam,
                xbar=1.0,  # d is already per-request
                kappa=tuple(float(v) for v in fr.params),
                r_min=float(r_min),
                r_max=float(r_max),
                cpu_min=1.0,  # at least one chip
                cpu_max=256.0,
            )
        )
    return apps


def build_fleet_engine(
    workloads: Sequence[WorkloadCost] | None = None,
    n_chips: int = 256,
    seed: int = 0,
    device=None,
):
    """One-stop fleet binding for the batched engine: fit Eq. (1) per workload
    on ``device``, pack the app set once (engine.PackedApps — pack once,
    solve many candidate batches), and size the pod caps. Returns (apps,
    packed, caps)."""
    from repro_torch.core.engine import PackedApps

    workloads = workloads or default_workloads()
    apps = build_fleet_apps(workloads, seed=seed, device=device)
    return apps, PackedApps.from_apps(apps), pod_caps(n_chips)


def fleet_allocator(
    workloads: Sequence[WorkloadCost] | None = None,
    n_chips: int = 256,
    alpha: float = 1.4,
    beta: float = 0.2,
    threshold: float = 0.15,
    seed: int = 0,
    options=None,
    device=None,
):
    """Fleet binding + a ready quasi-dynamic allocator wired to the structured
    O(M) Newton path and grid-seeded phase-1 (the production defaults of the
    pod binding), fitting and solving on ``device``. ``options`` is a
    repro_torch.api.SolverOptions; when None the defaults apply with
    ``threshold`` as the quasi-dynamic drift threshold. Returns (apps,
    packed, caps, allocator)."""
    from repro_torch.api.types import SolverOptions
    from repro_torch.core.crms import QuasiDynamicAllocator

    if options is None:
        options = SolverOptions(qd_threshold=threshold)
    apps, packed, caps = build_fleet_engine(workloads, n_chips=n_chips, seed=seed,
                                            device=device)
    allocator = QuasiDynamicAllocator(caps, alpha, beta, options=options, device=device)
    return apps, packed, caps, allocator


def pod_caps(n_chips: int = 256) -> ServerCaps:
    return ServerCaps(
        r_cpu=float(n_chips),
        r_mem=float(n_chips * HBM_PER_CHIP_GB),
        power=PowerModel(p_idle=TPU_V5E_CHIP_POWER.p_idle, p_full=TPU_V5E_CHIP_POWER.p_full),
    )


def workloads_from_roofline(path: str | Path) -> list[WorkloadCost]:
    """Build workload costs from the dry-run roofline JSON (decode cells)."""
    data = json.loads(Path(path).read_text())
    out = []
    for row in data:
        if row.get("shape") != "decode_32k" or row.get("mesh") != "single_pod":
            continue
        batch = row["global_batch"]
        out.append(
            WorkloadCost(
                name=row["arch"],
                flops_per_tok=row["hlo_flops_total"] / batch,
                bytes_per_tok=max(
                    (row["hlo_bytes_total"] - row.get("params_bytes", 0.0)) / batch
                    - row.get("kv_bytes_per_seq", 0.0),
                    1e6,
                ),
                params_bytes=row.get("params_bytes", 0.0),
                kv_bytes_per_seq=row.get("kv_bytes_per_seq", 1e8),
                coll_bytes_per_tok=row["collective_bytes_total"] / batch,
                lam=row.get("lam", 2.0),
            )
        )
    return out


# Analytic workloads (used before the dry-run table exists and in unit
# tests): rough per-arch decode costs at seq 32k from the config dims.
def default_workloads() -> list[WorkloadCost]:
    from repro_torch.configs import registry

    out = []
    lam_table = {  # heterogeneous request mix, sized to a 256-chip pod (the
        # heavyweights pin large HBM floors: params must fit per replica)
        "codeqwen1.5-7b": 5.0,
        "command-r-plus-104b": 0.3,
        "gemma-2b": 15.0,
        "minitron-4b": 8.0,
        "llama4-scout-17b-a16e": 1.5,
        "moonshot-v1-16b-a3b": 3.0,
        "jamba-1.5-large-398b": 0.2,
        "mamba2-130m": 30.0,
        "llama-3.2-vision-90b": 0.4,
        "seamless-m4t-large-v2": 6.0,
    }
    for arch_id, cfg in registry().items():
        n_active = cfg.active_params()
        n_total = cfg.total_params()
        kv = cfg.kv_bytes_per_seq(32768)
        out.append(
            WorkloadCost(
                name=arch_id,
                flops_per_tok=2.0 * n_active,
                bytes_per_tok=2.0 * n_active * 0.02,  # activation traffic est.
                params_bytes=2.0 * n_total,
                kv_bytes_per_seq=float(kv),
                coll_bytes_per_tok=2.0 * cfg.d_model * 2 * 4,  # TP partials est.
                lam=lam_table.get(arch_id, 2.0),
            )
        )
    return out
