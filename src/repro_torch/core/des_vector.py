"""Vectorized DES fast path: Kiefer–Wolfowitz segment simulation.

Between reconfiguration points every cluster of the fleet is a *stationary*
FCFS G/G/N_i segment, so instead of popping one heapq event at a time
(``core/des.py``, the reference oracle) the whole segment is simulated with
the c-server Kiefer–Wolfowitz workload-vector recurrence:

    w ∈ R^n ascending = unfinished work per server at the latest arrival;
    customer k (inter-arrival gap g_k, service s_k):
        w ← max(w - g_k, 0)          # servers work off backlog until arrival
        wait_k = w[0]                # FCFS: the earliest-free server
        w ← sort-insert(w[1:], wait_k + s_k)

The recurrence is exact for FCFS G/G/c, so per-customer response times
(wait + service) — and therefore mean, p95, and the sample-path occupancy
integrals (∫queue dt = Σ waits, ∫busy dt = Σ services) — come out of one
scan over pre-drawn variates with no event heap at all.

Batching: all M clusters advance in ONE step loop of float64 torch on the
device (the CUDA device unless the caller names another) — step k of lane i
is lane i's k-th customer (each lane carries its own inter-arrival gaps, so
lanes never synchronize). The inputs go to the device once per segment, the
loop never waits on the device, and the waits come back once. Server counts
pad to a pow2 with masked slots pinned at a large sentinel so they never win
the min; customer counts pad to a pow2 with a per-step validity mask, and
the loop stops at the last valid customer (the padded steps are exact
no-ops). ``backend="numpy"`` runs the same step as a host loop over NumPy
arrays, bit for bit the torch step's results; it is taken only when asked
for. Each step is separate elementwise launches (subtract, clamp, multiply,
add, min, max, selects): no fused multiply-add, so the device's waits equal
the host loop's bit for bit.

Hand-off invariants at ``configure()``/``retire()``/``activate()`` segment
boundaries (DESIGN.md §10):

* **In-service work carries.** Customers whose service STARTED inside a
  segment keep their completion time — exactly the event engine's "in-service
  keeps its drawn departure". Their absolute completion times seed the next
  segment's workload vector.
* **Queued customers replay.** Customers still waiting at a boundary re-enter
  the next segment's recurrence ahead of new arrivals (FCFS order preserved),
  keeping their true arrival times and already-drawn service times.
* **CRN streams are shared.** Arrival/service draws consume the same chunked
  ``(seed, name)``-keyed streams as the event engine, in the same order
  (FCFS makes service-start order equal arrival order), so for λ/n-only
  reconfiguration histories the two engines are sample-path identical up to
  float round-off. At a μ change the event engine re-draws queued work at
  service start (the new rate); here the queued draws are *rescaled* by
  mu_old/mu_new — exactly the new-rate law for exponential and balanced-H2
  service — so the backlog is served at the new speed in both engines, but
  from different draws: μ-boundary parity is statistical only.
* **Shrink is the non-preemptive limit.** Dropping the n - n' smallest
  workload entries reproduces the event engine's retire-as-they-finish rule:
  the queue resumes exactly at the (b - n' + 1)-th in-flight completion.
* **Lifecycle ramps split segments.** A cold-start scale-up
  (``core/lifecycle.py``) is a pending ramp applied at a deterministic
  instant: ``run_until``/``drain`` split the segment there and the n-change
  hand-off above carries queued and in-flight work through the ramp. The
  ramp consumes no draws, so CRN parity with the event engine's capacity
  event is structural, even for reconfigs landing mid-ramp.

Per-cluster logs, replay queues and percentiles stay NumPy on the host; only
the scan runs on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arrivals import ArrivalStream, parse_arrival, validate_service
from repro_torch.core.des import FleetSimulator, _service_chunk, _stream
from repro_torch.core.lifecycle import (
    INSTANT,
    parse_lifecycle,
    plan_capacity,
    settle_pending,
)
from repro_torch.device import F64, f64, resolve_device

_BIG = 1e30  # masked server-slot sentinel: never wins the min, absorbs gaps
_BACKENDS = ("auto", "torch", "numpy")


def _pad_pow2(k: int) -> int:
    return 1 << max(k - 1, 0).bit_length()


def _scan_target(backend: str, device) -> tuple[str, torch.device | None]:
    """(backend, device) of a scan: ``"numpy"`` runs on the host (no device);
    ``"auto"`` and ``"torch"`` run the torch step on the resolved device — the
    CUDA device for ``device=None``, a RuntimeError without one."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be auto|torch|numpy, got {backend!r}")
    if backend == "numpy":
        return "numpy", None
    return "torch", resolve_device(device)


def _host(x) -> np.ndarray:
    """A scan output as a NumPy array (a device tensor is copied here)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------------
# The segment scan: (M, n) workload carries, (K, M) per-customer inputs
# ----------------------------------------------------------------------------
def _kw_step_np(W, smask, g, s, v):
    """One batched Kiefer–Wolfowitz step (NumPy). Returns (W', waits).

    The sorted insert of the finishing customer's new workload uses the
    gather-free identity  out_j = max(r_{j-1}, min(r_j, new))  (r = the
    sorted survivors, r_{-1} = -inf, r_{n-1} = +inf): pure elementwise
    min/max — no rank reduction, no take_along_axis — that selects exactly
    the same floats as a sort."""
    Wd = np.maximum(W - g[:, None], 0.0)
    Wd[~smask] = _BIG
    wait = Wd[:, 0]
    new = wait + s
    hi = np.minimum(
        np.concatenate([Wd[:, 1:], np.full_like(Wd[:, :1], np.inf)], axis=1),
        new[:, None],
    )
    Wn = np.maximum(Wd, hi)  # r_{j-1} = Wd_j for j >= 1 ...
    Wn[:, 0] = hi[:, 0]  # ... and -inf at j = 0
    Wn[~smask] = _BIG
    W = np.where(v[:, None], Wn, W)
    return W, np.where(v, wait, 0.0)


def _segment_scan_numpy(W0, smask, gaps, svcs, valid):
    W = W0.copy()
    waits = np.empty_like(gaps)
    for k in range(gaps.shape[0]):
        W, waits[k] = _kw_step_np(W, smask, gaps[k], svcs[k], valid[k])
    return W, waits


def _segment_scan_torch(W0, smask, gaps, svcs, valid, K: int, dev):
    """``_kw_step_np`` as a torch step loop over the first K customers on
    ``dev``: the same floats, step by step. Returns device tensors
    (W_final (Mp, n_pad), waits (K, Mp))."""
    W = f64(W0, dev)
    sm = torch.as_tensor(smask, device=dev)
    v = torch.as_tensor(valid[:K], device=dev)
    g = f64(gaps[:K], dev).unbind(0)
    s = f64(svcs[:K], dev).unbind(0)
    big = torch.full_like(W, _BIG)
    inf_col = torch.full_like(W[:, :1], np.inf)
    waits = torch.empty((K, W.shape[0]), dtype=F64, device=dev)
    for k in range(K):
        Wd = torch.where(sm, torch.clamp_min(W - g[k][:, None], 0.0), big)
        wait = Wd[:, 0]
        new = wait + s[k]
        # gather-free sorted insert (see _kw_step_np)
        hi = torch.minimum(torch.cat((Wd[:, 1:], inf_col), dim=1), new[:, None])
        Wn = torch.maximum(Wd, hi)
        Wn[:, 0] = hi[:, 0]
        W = torch.where(v[k][:, None], torch.where(sm, Wn, big), W)
        waits[k] = wait
    return W, torch.where(v, waits, 0.0)


def segment_scan(W0, smask, gaps, svcs, valid, backend="auto", device=None):
    """Run the batched recurrence over one segment; NumPy in, NumPy out.
    Returns (W_final (Mp, n_pad), waits (K, Mp)), K the last valid customer
    step (``valid``'s rows past it are padding; their waits are 0 by
    definition and not returned). ``backend``: "auto"/"torch" run the torch
    step on ``device`` (None: the CUDA device), "numpy" the host loop."""
    backend, dev = _scan_target(backend, device)
    K = int(valid.sum(axis=0).max()) if valid.size else 0
    if backend == "numpy":
        Wf, waits = _segment_scan_numpy(W0, smask, gaps, svcs, valid)
        return Wf, waits[:K]
    Wf, waits = _segment_scan_torch(W0, smask, gaps, svcs, valid, K, dev)
    return _host(Wf), _host(waits)  # the one device->host copy of the segment


# ----------------------------------------------------------------------------
# Candidate-batched rollouts (DESIGN.md §14)
# ----------------------------------------------------------------------------
def _rollout_scan_torch(W0, gaps, svcs_unit, inv_mu, K: int):
    """The segment scan with a CANDIDATE axis B (the ``engine.ip_solve_rows``
    idiom applied to simulation): W0 is (Mp, n_pad, B) on the device,
    per-customer gaps/svcs_unit are (Kp, Mp) device tensors SHARED by every
    candidate — the common-random-number pairing — and inv_mu (Mp, B)
    rescales the unit-rate service draws inside the step, so the
    materialized draw arrays stay K·M, never K·B·M. B is the minor-most
    (contiguous) axis, so the server-slot shift of the sorted insert lands
    on a middle axis. Runs the first K customer steps; returns device
    tensors (W_final (Mp, n_pad, B), waits (K, Mp, B)).

    Leaner than ``_kw_step_np`` in three exact ways (results for every
    consumed entry are bitwise identical):
      * no masked-slot pinning: smask is fixed for a rollout, so the _BIG
        sentinels only DECAY by Sum(g) <= horizon over the whole run — 1e30
        minus a few hundred still loses every min and wins every max in
        float64, and the insert identity only consumes order;
      * no validity select on the carry: invalid rows are zero-padded
        (g = 0, su = 0), so the step removes the current min and re-inserts
        the SAME value — an exact no-op by the identity;
      * no validity select on the wait output: invalid/padded slots emit
        garbage that no scorer reads (the post-processing slices
        [n_arrivals - n_scored, n_arrivals) per lane)."""
    W = W0
    g = gaps[:K].unbind(0)
    su = svcs_unit[:K].unbind(0)
    inf_slab = torch.full_like(W[:, :1, :], np.inf)
    waits = torch.empty((K, *inv_mu.shape), dtype=F64, device=W.device)
    for k in range(K):
        Wd = torch.clamp_min(W - g[k][:, None, None], 0.0)
        wait = Wd[:, 0, :]
        new = wait + su[k][:, None] * inv_mu  # separate mul and add: no FMA
        # gather-free sorted insert (see _kw_step_np)
        hi = torch.minimum(torch.cat((Wd[:, 1:, :], inf_slab), dim=1), new[:, None, :])
        W = torch.maximum(Wd, hi)
        W[:, 0, :] = hi[:, 0, :]
        waits[k] = wait
    return W, waits


def _rollout_scan_numpy(W0, smask, gaps, svcs_unit, valid, inv_mu):
    """The host loop: the (Mp, B) candidate grid flattened to Mp·B lanes of
    the per-step kernel, so both backends share ``_kw_step_np``'s step."""
    Mp, n_pad, B = W0.shape
    Kp = gaps.shape[0]
    W = np.transpose(W0, (0, 2, 1)).reshape(Mp * B, n_pad).copy()
    sm = np.transpose(smask, (0, 2, 1)).reshape(Mp * B, n_pad)
    waits = np.empty((Kp, Mp, B))
    for k in range(Kp):
        g = np.broadcast_to(gaps[k][:, None], (Mp, B)).ravel()
        s = (svcs_unit[k][:, None] * inv_mu).ravel()
        v = np.broadcast_to(valid[k][:, None], (Mp, B)).ravel()
        W, w = _kw_step_np(W, sm, g, s, v)
        waits[k] = w.reshape(Mp, B)
    return np.transpose(W.reshape(Mp, B, n_pad), (0, 2, 1)), waits


def _unit_services(rng, service: str, h2_scv: float, k: int) -> np.ndarray:
    """k unit-rate (mu = 1) service draws in the engines' chunk pattern, so
    the underlying RNG sequence matches ``_VecCluster.services`` draw for
    draw; per-candidate times are ``unit_draw / mu`` (for exp AND balanced-H2
    both branch rates scale linearly in mu, so the rescale is the exact law)."""
    out = []
    need = int(k)
    while need > 0:
        buf = _service_chunk(rng, 1.0, service, h2_scv)
        take = min(need, buf.shape[0])
        out.append(buf[:take])
        need -= take
    return np.concatenate(out) if out else np.empty(0)


def _p95_cols(a: np.ndarray) -> np.ndarray:
    """``np.percentile(a, 95, axis=0)`` via a direct two-order-statistic
    partition + numpy's own lerp form — identical values, ~4x less
    machinery (the generic quantile path re-partitions per interpolation
    branch and dominates the rollout's post-processing otherwise)."""
    n = a.shape[0]
    if n == 1:
        return a[0].astype(float, copy=True)
    h = (n - 1) * 0.95
    i0 = int(h)
    t = h - i0
    p = np.partition(a, (i0, i0 + 1), axis=0)
    lo, hi = p[i0], p[i0 + 1]
    d = hi - lo
    return hi - d * (1 - t) if t >= 0.5 else lo + d * t


_CRN_CACHE: dict = {}
_CRN_CACHE_MAX = 8


@dataclasses.dataclass
class RolloutResult:
    """Per-candidate statistics of one batched rollout.

    Latency stats are NaN for an app that saw no (post-warmup) arrivals and
    +inf for a candidate that gives a traffic-bearing app zero servers (its
    requests never start — an honest never-served score for move ranking;
    these are ranking scores, not serialized epoch stats, so the DES NaN
    convention does not apply).

    ALL latency stats are computed lazily on first access and cached: the
    returned simulation (the wait matrix, on the scan's device) is complete,
    but the device->host copy, the per-app response materialization and the
    percentile partitions only run when a scorer actually reads
    ``mean_s``/``p95_s`` — and the pooled percentile (the across-app SLO
    view, ``pooled_*``) only when someone reads that. A refinement ranking
    moves by per-app means never pays for percentiles it does not look at."""

    names: tuple
    n_arrivals: np.ndarray  # (M,) arrivals drawn per app (shared CRN)
    n_scored: np.ndarray  # (M,) arrivals inside the post-warmup window
    horizon_s: float
    n_events: int  # total simulated customer steps per candidate
    # (waits, svcs_u, inv_mu, served, B, M); consumed (and released) by the
    # first stats access
    _raw: tuple | None = dataclasses.field(default=None, repr=False)
    _mean_s: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _p95_s: np.ndarray | None = dataclasses.field(default=None, repr=False)
    _pooled: list = dataclasses.field(default_factory=list, repr=False)
    _pooled_has_inf: np.ndarray | None = dataclasses.field(
        default=None, repr=False
    )
    _pooled_cache: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def _stats(self) -> tuple:
        if self._mean_s is None:
            waits, svcs_u, inv_mu, served, B, M = self._raw
            waits = _host(waits)  # device->host happens here, once
            mean_s = np.full((B, M), np.nan)
            p95_s = np.full((B, M), np.nan)
            pooled_has_inf = np.zeros(B, dtype=bool)
            # NaN-free hot path: arrivals are time-sorted, so the warmup
            # filter is a searchsorted SLICE (a view, no boolean copy), and
            # zero-server candidates keep their _BIG-workload garbage through
            # the plain mean/percentile and are overwritten with inf after —
            # NaN masking + nanpercentile costs ~10x (per-column fallback).
            for i in range(M):
                k = int(self.n_arrivals[i])
                kk = int(self.n_scored[i])
                if kk == 0:
                    continue
                lo = k - kk
                r = waits[lo:k, i, :] + svcs_u[i][lo:k, None] * inv_mu[i][None, :]
                mean_s[:, i] = np.where(served[:, i], np.mean(r, axis=0), np.inf)
                p95_s[:, i] = np.where(served[:, i], _p95_cols(r), np.inf)
                self._pooled.append(r)
                pooled_has_inf |= ~served[:, i]
            self._mean_s, self._p95_s = mean_s, p95_s
            self._pooled_has_inf = pooled_has_inf
            self._raw = None  # release the (K, Mp, B) wait matrix
        return self._mean_s, self._p95_s

    @property
    def mean_s(self) -> np.ndarray:  # (B, M)
        return self._stats()[0]

    @property
    def p95_s(self) -> np.ndarray:  # (B, M)
        return self._stats()[1]

    def _pool(self) -> tuple:
        if self._pooled_cache is None:
            b = self._stats()[0].shape[0]
            if not self._pooled:
                self._pooled_cache = (np.full(b, np.nan), np.full(b, np.nan))
            else:
                allr = np.concatenate(self._pooled, axis=0)  # (sum kk, B)
                inf = self._pooled_has_inf
                self._pooled_cache = (
                    np.where(inf, np.inf, np.mean(allr, axis=0)),
                    np.where(inf, np.inf, _p95_cols(allr)),
                )
        return self._pooled_cache

    @property
    def pooled_mean_s(self) -> np.ndarray:  # (B,)
        return self._pool()[0]

    @property
    def pooled_p95_s(self) -> np.ndarray:  # (B,)
        return self._pool()[1]


def rollout_candidates(
    names,
    lam,
    mu,
    n_servers,
    horizon_s: float,
    *,
    seed: int = 0,
    t0: float = 0.0,
    warmup_s: float = 0.0,
    arrival=None,
    service: str = "exp",
    h2_scv: float = 4.0,
    backend: str = "auto",
    device=None,
) -> RolloutResult:
    """Simulate B candidate allocations × M apps over SHARED CRN draws in ONE
    batched Kiefer–Wolfowitz scan (DESIGN.md §14), on ``device`` (None: the
    CUDA device) unless ``backend="numpy"`` asks for the host loop.

    Every candidate sees the *same* arrival times and the same unit-rate
    service draws (rescaled by its own per-app mu inside the scan), so
    candidate comparisons are paired — the difference estimator's variance
    drops by the between-path component, which is what makes SHORT rollouts
    decisive for greedy-refinement move ranking. With B = 1 the sample path
    is identical to ``VectorFleetSimulator`` (same streams, same recurrence).

    names/lam: the M apps (CRN stream keys) and their arrival rates;
    mu/n_servers: (B, M) per-candidate service rates and container counts;
    arrival: one spec for the fleet or a length-M per-app list (same forms
    as ``FleetSimulator``). The rollout is a fresh [t0, t0+horizon_s) world
    per call — no SIMULATION state carries between calls; the padded CRN
    draw arrays themselves are memoized on (names, lam, seed, window, spec,
    device) and committed to the device once, because the greedy refinement
    deliberately re-rolls the SAME world every iteration (that is what makes
    its objective deterministic) and regenerating identical streams per call
    would double the per-call cost.
    """
    mu = np.asarray(mu, dtype=float)
    n_srv = np.asarray(n_servers, dtype=int)
    if mu.ndim != 2 or n_srv.shape != mu.shape:
        raise ValueError(
            f"mu and n_servers must both be (B, M), got {mu.shape} / {n_srv.shape}"
        )
    B, M = mu.shape
    lam = np.asarray(lam, dtype=float)
    if lam.shape != (M,) or len(names) != M:
        raise ValueError(f"need {M} names and (M,) lam for (B, {M}) candidates")
    if np.any(mu <= 0.0):
        raise ValueError("every candidate mu must be > 0")
    if horizon_s <= 0.0 or warmup_s < 0.0 or warmup_s >= horizon_s:
        raise ValueError("need horizon_s > 0 and 0 <= warmup_s < horizon_s")
    validate_service(service, h2_scv)
    specs = (
        [parse_arrival(a) for a in arrival]
        if isinstance(arrival, (list, tuple))
        else [parse_arrival(arrival)] * M
    )
    if len(specs) != M:
        raise ValueError(f"per-app arrival list must have length {M}")
    backend, dev = _scan_target(backend, device)

    key = (tuple(names), lam.tobytes(), int(seed), float(t0), float(horizon_s),
           repr(arrival), service, float(h2_scv), dev)
    cached = _CRN_CACHE.pop(key, None)  # pop+reinsert: crude LRU ordering
    if cached is None:
        t_end = t0 + float(horizon_s)
        arrs, svcs_u = [], []
        for i, name in enumerate(names):
            stream = ArrivalStream(specs[i], float(lam[i]), seed, name, t0)
            times = stream.times_until(t_end)
            arrs.append(times)
            svcs_u.append(_unit_services(_stream(seed, name, 29), service,
                                         h2_scv, times.shape[0]))
        n_arrivals = np.array([a.shape[0] for a in arrs], dtype=int)
        K = int(n_arrivals.max()) if M else 0
        Kp, Mp = _pad_pow2(K), _pad_pow2(M)
        gaps = np.zeros((Kp, Mp))
        su = np.zeros((Kp, Mp))
        valid = np.zeros((Kp, Mp), dtype=bool)
        for i, (times, s) in enumerate(zip(arrs, svcs_u)):
            k = times.shape[0]
            gaps[:k, i] = np.diff(times, prepend=t0)
            su[:k, i] = s
            valid[:k, i] = True
        if dev is not None:  # commit once so cache hits skip the host->device copy
            gaps, su = f64(gaps, dev), f64(su, dev)
        cached = (arrs, svcs_u, n_arrivals, K, gaps, su, valid)
    _CRN_CACHE[key] = cached
    while len(_CRN_CACHE) > _CRN_CACHE_MAX:
        _CRN_CACHE.pop(next(iter(_CRN_CACHE)))
    arrs, svcs_u, n_arrivals, K, gaps, su, valid = cached

    n_scored = np.zeros(M, dtype=int)
    for i in range(M):
        k = int(n_arrivals[i])
        if k:
            n_scored[i] = k - int(np.searchsorted(arrs[i], t0 + warmup_s))
    if K == 0:
        nan = np.full((B, M), np.nan)
        return RolloutResult(
            names=tuple(names), n_arrivals=n_arrivals.copy(),
            n_scored=n_scored, horizon_s=float(horizon_s), n_events=0,
            _mean_s=nan, _p95_s=nan.copy(),
        )

    Mp = _pad_pow2(M)
    n_pad = _pad_pow2(max(int(n_srv.max()), 1))
    smask = np.zeros((Mp, n_pad, B), dtype=bool)
    smask[:M] = np.arange(n_pad)[None, :, None] < n_srv.T[:, None, :]
    inv_mu = np.zeros((Mp, B))
    inv_mu[:M] = 1.0 / mu.T
    W0 = np.where(smask, 0.0, _BIG)

    if backend == "torch":
        _, waits = _rollout_scan_torch(f64(W0, dev), gaps, su, f64(inv_mu, dev), K)
        if dev.type == "cuda":  # the returned simulation IS complete; only
            torch.cuda.synchronize(dev)  # the scoring stats are lazy
    else:
        _, waits = _rollout_scan_numpy(W0, smask, gaps, su, valid, inv_mu)
        waits = waits[:K]

    served = n_srv > 0  # (B, M): zero-server lanes never start their work
    return RolloutResult(
        names=tuple(names), n_arrivals=n_arrivals.copy(), n_scored=n_scored,
        horizon_s=float(horizon_s), n_events=int(n_arrivals.sum()),
        _raw=(waits, svcs_u, inv_mu, served, B, M),
    )


# Per-cluster segment state
# ----------------------------------------------------------------------------
class _VecCluster:
    """One cluster's carried state between segments: chunked CRN buffers, the
    pending (already-drawn) arrival, in-flight completion times, the replay
    queue, and the finalized per-customer logs."""

    __slots__ = (
        "name", "lam", "mu", "mu_base", "n_servers", "active", "service",
        "h2_scv",
        "arr", "svc_rng", "_svc_buf", "_svc_pos",
        "inflight", "queue_t", "queue_s",
        "log_t", "log_w", "log_s", "_log_cache", "n_arrived",
        "lc", "warm_avail", "warm_target", "pending",
        "fp", "down",
    )

    def __init__(self, name, lam, mu, n_servers, seed, t0, service, h2_scv,
                 arrival=None, lifecycle=INSTANT, fp=None):
        self.name = name
        self.lam = float(lam)
        self.mu = float(mu)
        self.mu_base = float(mu)  # the configured rate; mu is the effective
        self.n_servers = int(n_servers)
        self.fp = fp  # FailureProcess (crash/repair event source) or None
        self.down = 0  # crashed-and-not-yet-repaired containers
        self.active = True
        self.service = service
        self.h2_scv = float(h2_scv)
        # the SAME chunked stream object the event engine consumes: one
        # drawn-ahead pending arrival, phase chain resolved eagerly
        self.arr = ArrivalStream(arrival, lam, seed, name, t0)
        self.svc_rng = _stream(seed, name, 29)
        self._svc_buf = np.empty(0)
        self._svc_pos = 0
        # container lifecycle: same state machine as the event engine's
        # _Cluster — at most one pending ramp, applied at segment boundaries
        self.lc = lifecycle
        self.warm_avail = lifecycle.warm_pool
        self.warm_target = lifecycle.warm_pool
        self.pending: tuple[float, int, int] | None = None
        self.inflight = np.empty(0)  # absolute completion times, > clock
        self.queue_t = np.empty(0)  # waiting customers: true arrival times
        self.queue_s = np.empty(0)  # ...and their already-drawn service times
        self.log_t: list[np.ndarray] = []  # finalized: arrival / wait / service
        self.log_w: list[np.ndarray] = []
        self.log_s: list[np.ndarray] = []
        self._log_cache: tuple | None = None
        self.n_arrived = 0

    @property
    def n_up(self) -> int:
        """Effective capacity: configured servers minus crashed containers
        (the event engine's ``_Cluster.n_up``)."""
        d = self.down
        return self.n_servers - d if d < self.n_servers else 0

    # --------------------------------------------------------- CRN streams
    def arrivals_until(self, t_end: float) -> np.ndarray:
        """Absolute arrival times <= t_end — the stream's batched
        phase-conditioned cumsum pull; leaves the overshoot arrival pending
        (exactly one drawn-ahead arrival, like the event engine's heap
        entry)."""
        arr = self.arr.times_until(t_end)
        self.n_arrived += arr.shape[0]
        return arr

    def services(self, k: int) -> np.ndarray:
        """k service draws from the chunked stream. FCFS service-start order
        equals arrival order, so consuming at arrival keeps the sequence
        aligned with the event engine's consume-at-start."""
        out = []
        need = int(k)
        while need > 0:
            if self._svc_pos >= self._svc_buf.shape[0]:
                self._svc_buf = _service_chunk(
                    self.svc_rng, self.mu, self.service, self.h2_scv
                )
                self._svc_pos = 0
            take = min(need, self._svc_buf.shape[0] - self._svc_pos)
            out.append(self._svc_buf[self._svc_pos:self._svc_pos + take])
            self._svc_pos += take
            need -= take
        return np.concatenate(out) if out else np.empty(0)

    # ------------------------------------------------------------- carries
    def workload_at(self, t0: float, n_pad: int) -> np.ndarray:
        """The segment-start workload vector: in-flight remainders ascending,
        idle servers at 0, masked slots at the sentinel. After a shrink the
        n_servers LARGEST remainders stay — the non-preemptive limit (the
        queue resumes at the (b - n' + 1)-th in-flight completion, exactly
        when the event engine's server count re-reaches n')."""
        w = np.full(n_pad, _BIG)
        n = self.n_up  # crashed containers are masked out, largest remainders stay
        if n == 0:
            return w
        rem = np.sort(self.inflight - t0)
        rem = rem[rem > 0.0]
        if rem.shape[0] > n:
            rem = rem[-n:]
        w[:n] = 0.0
        if rem.shape[0]:
            w[n - rem.shape[0]:n] = rem
        return w

    def record(self, t_arr, wait, svc) -> None:
        if t_arr.shape[0]:
            self.log_t.append(t_arr)
            self.log_w.append(wait)
            self.log_s.append(svc)
            self._log_cache = None

    def logs(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._log_cache is None:
            if self.log_t:
                self._log_cache = (
                    np.concatenate(self.log_t),
                    np.concatenate(self.log_w),
                    np.concatenate(self.log_s),
                )
            else:
                self._log_cache = (np.empty(0), np.empty(0), np.empty(0))
        return self._log_cache


# ----------------------------------------------------------------------------
# The fleet
# ----------------------------------------------------------------------------
class VectorFleetSimulator(FleetSimulator):
    """Drop-in ``FleetSimulator(engine="vector")`` implementation: same admin
    and stats contract, but ``run_until`` advances one whole stationary
    segment per call through the batched recurrence instead of an event loop.

    ``backend`` pins the scan implementation ("torch" | "numpy" | "auto");
    ``device`` is the torch step's (None: the CUDA device, RuntimeError
    without one). "numpy" runs the host loop and needs no device.

    One intentional pre-``drain()`` difference from the oracle: a customer's
    response is final once its service STARTS, so ``responses()`` before
    ``drain()`` already includes in-service customers the event engine would
    only log at departure. After ``drain()`` (the documented stats workflow)
    the two engines report identical windows."""

    engine = "vector"

    def __init__(
        self,
        seed: int = 0,
        engine: str = "vector",
        service: str = "exp",
        h2_scv: float = 4.0,
        backend: str = "auto",
        arrival=None,
        lifecycle=None,
        failures=None,
        device=None,
    ):
        if engine != "vector":
            raise ValueError(f"VectorFleetSimulator is engine='vector', got {engine!r}")
        self.backend, self.device = _scan_target(backend, device)
        super().__init__(
            seed=seed, service=service, h2_scv=h2_scv, arrival=arrival,
            lifecycle=lifecycle, failures=failures,
        )
        self._clusters: dict[str, _VecCluster] = {}

    # ------------------------------------------------------------------ admin
    def add_app(
        self, name: str, lam: float, mu: float, n_servers: int, arrival=None,
        lifecycle=None, failures=None,
    ) -> None:
        if name in self._clusters:
            raise ValueError(f"app {name!r} already simulated")
        if mu <= 0 or n_servers < 0:
            raise ValueError(f"app {name!r}: need mu > 0 and n_servers >= 0")
        spec = self.arrival if arrival is None else parse_arrival(arrival)
        lc = self.lifecycle if lifecycle is None else parse_lifecycle(lifecycle)
        lc = lc.for_app(name)  # per-app t_cold resolved to a scalar spec
        fp = self._make_fp(name, failures, lc)
        cl = _VecCluster(
            name, lam, mu, n_servers, seed=self.seed, t0=self.t,
            service=self.service, h2_scv=self.h2_scv, arrival=spec,
            lifecycle=lc, fp=fp,
        )
        self._clusters[name] = cl

    def configure(self, name, lam=None, mu=None, n_servers=None,
                  warm_pool=None) -> None:
        """Segment boundary at the current instant; see the module docstring
        for the carried-work semantics. Lifecycle ramps follow the SAME
        ``plan_capacity`` transition as the event engine; a pending ramp is
        applied by ``run_until``/``drain`` splitting the segment at the ramp
        instant — the existing hand-off machinery makes the split exact."""
        cl = self._cluster(name)
        if lam is not None and float(lam) != cl.lam:
            cl.lam = float(lam)
            cl.arr.set_lam(float(lam), self.t)  # supersede the pending arrival
        if mu is not None and float(mu) != cl.mu_base:
            if mu <= 0:
                raise ValueError(f"app {name!r}: mu must be > 0")
            # The oracle re-draws queued work at service START, i.e. at the
            # new rate. Rescaling the queued draws keeps that law exactly —
            # c·Exp(mu_old) with c = mu_old/mu_new IS Exp(mu_new), and the
            # balanced-means H2 branch rates both scale linearly in mu — so
            # a congested boundary followed by a scale-up serves its backlog
            # at the new speed instead of the stale one. A live straggler
            # episode keeps degrading the NEW configured rate.
            cl.mu_base = float(mu)
            frac = cl.fp.spec.straggler_frac if (cl.fp is not None and cl.fp.slow) else 1.0
            mu_eff = cl.mu_base * frac
            cl.queue_s = cl.queue_s * (cl.mu / mu_eff)
            cl.mu = mu_eff
            cl._svc_buf = np.empty(0)
            cl._svc_pos = 0
        if n_servers is not None or warm_pool is not None:
            settle_pending(cl, self.t)  # apply a ramp that already landed
            cl.n_servers, cl.warm_avail, cl.warm_target, cl.pending = plan_capacity(
                self.t, cl.n_servers, cl.warm_avail, cl.warm_target,
                cl.lc.t_cold, n_servers, warm_pool,
            )  # instant part: next workload_at() applies it; rest is pending

    def retire(self, name: str) -> None:
        cl = self._cluster(name)
        cl.active = False
        cl.arr.deactivate()  # the consumed draw is discarded, as in the oracle

    def activate(self, name: str) -> None:
        cl = self._cluster(name)
        if cl.active:
            return
        cl.active = True
        cl.arr.reactivate(self.t)

    # ------------------------------------------------------------- event loop
    def _settle_due(self) -> float:
        """Apply every pending ramp that is due at the current clock; return
        the earliest still-pending ramp instant (inf when none). Ramps land
        at segment boundaries, so applying them between segments reproduces
        the event engine's capacity event exactly."""
        t_next = np.inf
        for cl in self._clusters.values():
            settle_pending(cl, self.t)
            if cl.pending is not None:
                t_next = min(t_next, cl.pending[0])
        return t_next

    def _next_fail(self) -> float:
        """Earliest pending crash/repair instant across the fleet (inf when
        no stochastic failures are configured)."""
        t = np.inf
        for cl in self._clusters.values():
            if cl.fp is not None:
                t = min(t, cl.fp.next_change())
        return t

    def _apply_failures(self) -> None:
        """Land every FailureProcess event due at the current clock — the
        vector-engine twin of the event engine's ``_apply_failure``. Crashes
        and repairs are pure capacity changes (no draws consumed), applied
        between segments at exactly the instants the event engine's heap
        processes them, so crash/repair parity is structural; a straggler
        episode boundary changes the effective μ (statistical parity, the
        configure-μ law)."""
        for cl in self._clusters.values():
            fp = cl.fp
            if fp is None or fp.next_change() > self.t:
                continue
            out = fp.apply_at(self.t, cl.n_up)
            fp.gen += 1
            if out["d_down"]:
                cl.down = max(cl.down + out["d_down"], 0)
            if not fp.spec.crash_mode:
                mu_eff = cl.mu_base * (fp.spec.straggler_frac if fp.slow else 1.0)
                if mu_eff != cl.mu:
                    cl.queue_s = cl.queue_s * (cl.mu / mu_eff)
                    cl.mu = mu_eff
                    cl._svc_buf = np.empty(0)
                    cl._svc_pos = 0

    def run_until(self, t_end: float) -> None:
        if not np.isfinite(t_end):
            raise ValueError("run_until(t_end) needs a finite horizon; use drain()")
        t_end = float(t_end)
        while True:
            t_ramp = self._settle_due()  # pending capacity ramps split segments
            self._apply_failures()  # ...and so do crash/repair instants
            t_next = min(t_ramp, self._next_fail())
            t_seg = min(t_end, t_next)
            if t_seg > self.t:
                self._simulate_segment(t_seg, drain=False)
                self.t = t_seg
            if t_next <= t_end:
                continue  # the loop lands the ramp/failure at self.t == t_next
            break

    def drain(self) -> None:
        """Stop arrivals and finalize every admitted customer. The recurrence
        already computed in-flight completions, so draining is one unbounded
        segment over the replay queues — after landing any pending capacity
        ramps (cold containers still boot while the fleet drains, exactly as
        the event engine's heap processes its capacity events). New crashes
        halt (the ``FailureProcess`` drain contract) but pending repairs
        still split segments and land, so work stranded by a crash completes
        once its replacement boots."""
        for cl in self._clusters.values():
            cl.arr.cancel_pending()
            if cl.fp is not None:
                cl.fp.halt()  # stop new crashes; repairs stay pending
        while True:
            t_ramp = self._settle_due()
            self._apply_failures()
            t_next = min(t_ramp, self._next_fail())
            if not np.isfinite(t_next):
                break
            if t_next > self.t:
                self._simulate_segment(t_next, drain=False)
                self.t = t_next
        t_done = self._simulate_segment(np.inf, drain=True)
        self.t = max(self.t, t_done)

    # --------------------------------------------------------------- failures
    def crash(self, name: str, k: int = 1) -> None:
        """Scripted crash at the current instant (a segment boundary) — the
        next segment's workload vector masks the crashed containers out."""
        cl = self._cluster(name)
        cl.down += min(int(k), cl.n_up)

    def repair(self, name: str, k: int = 1) -> None:
        """Scripted repair at the current instant (a segment boundary)."""
        cl = self._cluster(name)
        cl.down = max(cl.down - int(k), 0)

    def _simulate_segment(self, t_end: float, drain: bool) -> float:
        """Advance every cluster from the current clock to t_end (one
        stationary segment) through one batched scan. Returns the time of the
        last completion (for drain's clock semantics)."""
        t0 = self.t
        work = []
        for cl in self._clusters.values():
            arr = cl.arrivals_until(t_end)
            svc = cl.services(arr.shape[0])
            nq = cl.queue_t.shape[0]
            # replayed queued customers go first (FCFS), at effective time t0
            eff = np.concatenate((np.full(nq, t0), arr))
            tru = np.concatenate((cl.queue_t, arr))
            s = np.concatenate((cl.queue_s, svc))
            work.append((cl, eff, tru, s))
        K = max((e.shape[0] for _, e, _, _ in work), default=0)
        if K == 0:
            return t0
        Kp = _pad_pow2(K)
        Mp = _pad_pow2(len(work))
        n_pad = _pad_pow2(max(max(cl.n_up for cl, *_ in work), 1))

        W0 = np.full((Mp, n_pad), _BIG)
        smask = np.zeros((Mp, n_pad), dtype=bool)
        gaps = np.zeros((Kp, Mp))
        svcs = np.zeros((Kp, Mp))
        valid = np.zeros((Kp, Mp), dtype=bool)
        for i, (cl, eff, _, s) in enumerate(work):
            W0[i] = cl.workload_at(t0, n_pad)
            smask[i, : cl.n_up] = True
            k = eff.shape[0]
            gaps[:k, i] = np.diff(eff, prepend=t0)
            svcs[:k, i] = s
            valid[:k, i] = True

        _, waits = segment_scan(W0, smask, gaps, svcs, valid, backend=self.backend,
                                device=self.device)

        t_last = t0
        for i, (cl, eff, tru, s) in enumerate(work):
            if drain and cl.inflight.shape[0]:
                t_last = max(t_last, float(cl.inflight.max()))
            k = eff.shape[0]
            if k == 0:
                cl.inflight = cl.inflight[cl.inflight > t_end]
                continue
            start = eff + waits[:k, i]
            comp = start + s
            # wait >= the sentinel means "no server will ever free" (n=0):
            # those customers stay queued even through drain, as in the oracle
            can_start = waits[:k, i] < 0.5 * _BIG
            started = can_start if drain else can_start & (start <= t_end)
            cl.record(tru[started], (start - tru)[started], s[started])
            cl.queue_t = tru[~started]
            cl.queue_s = s[~started]
            done = comp[started]
            cl.inflight = np.concatenate(
                (cl.inflight[cl.inflight > t_end], done[done > t_end])
            )
            if done.shape[0]:
                t_last = max(t_last, float(done.max()))
        return t_last

    # ------------------------------------------------------------------ stats
    def snapshot(self, name: str) -> tuple[float, float]:
        """(qlen_integral, busy_time) at the current clock, from the exact
        sample-path identities: every customer contributes its waiting
        interval to the queue integral and its service interval to the busy
        integral, clipped at the clock."""
        cl = self._cluster(name)
        t = self.t
        t_arr, wait, svc = cl.logs()
        start = t_arr + wait
        qlen = float(np.sum(np.clip(np.minimum(start, t) - t_arr, 0.0, None)))
        if cl.queue_t.shape[0]:
            qlen += float(np.sum(np.clip(t - cl.queue_t, 0.0, None)))
        busy = float(np.sum(np.clip(np.minimum(start + svc, t) - start, 0.0, None)))
        return qlen, busy

    def responses(self, name: str, t_start: float, t_end: float) -> np.ndarray:
        cl = self._cluster(name)
        t_arr, wait, svc = cl.logs()
        mask = (t_arr >= t_start) & (t_arr < t_end)
        return (wait + svc)[mask]

    def mean_response(self, names, t_start: float, t_end: float):
        """Vectorized pooled mean for the placement-validation hook: running
        (sum, count) straight off each cluster's chunked logs — no
        per-cluster response-array materialization or concatenation (the
        sampled-node pools are exactly the many-small-clusters shape the
        base implementation is slowest at)."""
        total = 0.0
        count = 0
        for name in names:
            cl = self._cluster(name)
            t_arr, wait, svc = cl.logs()
            mask = (t_arr >= t_start) & (t_arr < t_end)
            count += int(np.count_nonzero(mask))
            total += float(np.sum(wait[mask]) + np.sum(svc[mask]))
        if count == 0:
            return float("nan"), 0
        return total / count, count
