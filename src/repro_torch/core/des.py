"""Fleet-scale discrete-event M/M/N simulation (replaces the paper's SimPy
harness AND the old single-cluster toy).

One event loop simulates every application's M/M/N_i cluster simultaneously:
Poisson arrivals per app, N_i parallel exponential servers, FCFS queues —
exactly the §IV-B model, but as a *fleet*. The simulator is the independent
evaluation layer behind ``ScenarioRunner(backend="des")``: it replays each
decision epoch's arrivals against the allocation a policy actually chose and
reports *achieved* latency next to the analytic model's prediction.

Design points (DESIGN.md §10):

* **Vectorized event batching** — inter-arrival and service draws come from
  NumPy-batched exponential chunks per cluster (one ``rng.exponential(size=…)``
  per ~4k draws), so the Python event loop never calls the RNG per event.
  Window statistics (mean/p95/queue integrals) are likewise computed by
  vectorized masking over the per-cluster completion logs.
* **Common-random-number arrivals** — each cluster's arrival stream is seeded
  by ``(seed, app name)`` only, so every policy replayed through the same
  scenario sees the *same* arrival process; only service dynamics differ.
* **Mid-run reconfiguration** — ``configure()`` changes ``lam``/``mu``/
  ``n_servers`` at any instant, *carrying in-flight work*: requests already in
  service keep their scheduled departure (service time was drawn at start),
  new service starts use the new rate, and a shrink below the busy count is
  non-preemptive (excess servers retire as they finish). λ changes are exact
  by memorylessness: the pending arrival is superseded by a fresh draw at the
  new rate.
* **Warmup-correct integrals** — queue-length and busy-time integrals are
  read via ``snapshot()`` at arbitrary instants and differenced over the
  measurement window, so ``mean_queue_len``/``utilization`` exclude the
  warmup transient exactly like the response-time log does.
* **Two engines, one contract** — ``FleetSimulator(engine="event")`` is the
  heapq reference oracle in this module; ``engine="vector"`` dispatches to
  the Kiefer–Wolfowitz workload-vector fast path in ``core/des_vector.py``
  (a per-segment torch step loop over pre-drawn variates, batched across
  apps, on the CUDA device by default), which consumes the *same* chunked
  common-random-number streams and is CRN-matched against this engine.
  The event engine runs on the host and takes no device: a ``device``
  keyword given to it is accepted and ignored.
* **Service-time law** — ``service="exp"`` (the paper's M/M/N model) or
  ``service="h2"``: a balanced-means two-branch hyperexponential with
  squared coefficient of variation ``h2_scv`` (> 1), the first non-Poisson
  knob of the ROADMAP follow-on. Erlang-C-optimized allocations degrade
  measurably under H2 — the off-model gap the DES exists to expose.
* **Container lifecycle** — ``lifecycle=LifecycleSpec(t_cold, warm_pool)``
  (``core/lifecycle.py``; fleet default or per-app via ``add_app``): a
  ``configure()`` scale-up beyond the warm pool ramps in only after the
  cold-start lag (a pending capacity event; superseded by the next
  configure), shrinks park freed containers into the pool, and the pool
  replenishes by booting. Capacity events never touch the CRN draw streams,
  so event-vs-vector parity is preserved through mid-ramp reconfigs.
* **Arrival law** — ``arrival=None`` (Poisson, the paper's model) or an
  MMPP spec (``core/arrivals.py``): a Markov-modulated Poisson process whose
  modulating chain and gap draws live in a shared ``ArrivalStream`` consumed
  by BOTH engines, so bursty arrivals keep exact CRN engine parity. Per-app
  overrides via ``add_app(..., arrival=...)``.
* **Failure injection** — ``failures=FailureSpec(mtbf, mttr, ...)``
  (``core/failures.py``; fleet default or per-app via ``add_app``): an
  exponential crash–repair process drawn from a DEDICATED CRN stream
  (``(seed, name, FAIL_SALT)``). A crash takes one container down
  non-preemptively (its in-flight request completes; effective capacity
  ``n_up = n_servers − down`` shrinks by one); the repair lands at
  ``t_crash + repair + t_cold`` — the repaired container is cold, so it
  pays the app's own cold-start lag. Straggler mode
  (``straggler_frac < 1``) degrades the cluster's service rate to
  ``frac·μ`` for the episode instead (the configure-μ law, so engine
  parity through straggler episodes is statistical, not structural).
  ``drain()`` halts new crashes but still lands pending repairs. Scripted
  failures (the ``ContainerCrash``/``ContainerRepair`` scenario events)
  use ``crash()``/``repair()`` directly. With failures off, no failure
  stream exists and every draw is byte-identical to the pre-failure
  engines.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.arrivals import (  # noqa: F401  (re-exported: historical home)
    _CHUNK,
    ArrivalStream,
    _stream,
    h2_params,
    parse_arrival,
    validate_service,
)
from repro_torch.core.failures import FailureProcess, parse_failures
from repro_torch.core.lifecycle import (
    INSTANT,
    LifecycleSpec,
    parse_lifecycle,
    plan_capacity,
    settle_pending,
)

_ARRIVAL, _DEPART, _CAPACITY, _FAILURE = 0, 1, 2, 3
_ENGINES = ("event", "vector")
_SERVICES = ("exp", "h2")


def _service_chunk(
    rng: np.random.Generator, mu: float, service: str, h2_scv: float
) -> np.ndarray:
    """One chunk of service-time draws. The ``exp`` recipe is byte-identical
    to the historical one (seeded results unchanged); ``h2`` spends one
    uniform + one unit-exponential per draw."""
    if service == "exp":
        return rng.exponential(1.0 / mu, size=_CHUNK)
    p, mu1, mu2 = h2_params(mu, h2_scv)
    u = rng.random(_CHUNK)
    e = rng.exponential(1.0, size=_CHUNK)
    return e / np.where(u < p, mu1, mu2)


@dataclasses.dataclass
class SimStats:
    """Per-window statistics. An EMPTY window (n_completed == 0) reports
    mean/p95 as NaN — not inf, which read as "infinitely slow" in pooled
    aggregates and is not valid JSON — so consumers must branch on
    ``n_completed`` (or ``math.isnan``), never compare the latency fields
    of a window that may be empty."""

    n_completed: int
    mean_response_s: float
    p95_response_s: float
    mean_queue_len: float
    utilization: float


class _Cluster:
    """One application's M/M/N cluster inside the fleet loop."""

    __slots__ = (
        "name", "lam", "mu", "mu_base", "n_servers", "busy", "queue",
        "version", "active",
        "arr", "svc_rng", "_svc_buf", "_svc_pos",
        "arr_log", "resp_log", "n_arrived", "qlen_integral", "busy_time",
        "last_t", "service", "h2_scv",
        "lc", "warm_avail", "warm_target", "pending", "cap_version",
        "fp", "down",
    )

    def __init__(self, name, lam, mu, n_servers, arr, svc_rng, t0,
                 service="exp", h2_scv=4.0, lifecycle=INSTANT, fp=None):
        self.name = name
        self.lam = float(lam)
        self.mu = float(mu)
        self.mu_base = float(mu)  # the configured rate; mu is the effective
        self.n_servers = int(n_servers)
        self.fp = fp  # FailureProcess (crash/repair event source) or None
        self.down = 0  # crashed-and-not-yet-repaired containers
        self.service = service
        self.h2_scv = float(h2_scv)
        self.busy = 0
        self.queue: deque[float] = deque()  # arrival times of waiting requests
        self.version = 0  # bumps on λ reconfig; stale arrival events are dropped
        self.active = True  # arrivals enabled
        self.arr: ArrivalStream = arr  # shared-with-vector-engine CRN stream
        self.svc_rng = svc_rng
        self._svc_buf = np.empty(0)
        self._svc_pos = 0
        # container lifecycle (core/lifecycle.py): at most ONE pending
        # capacity ramp, (t_ready, n_final, warm_after); superseded on the
        # next configure via cap_version
        self.lc: LifecycleSpec = lifecycle
        self.warm_avail = lifecycle.warm_pool
        self.warm_target = lifecycle.warm_pool
        self.pending: tuple[float, int, int] | None = None
        self.cap_version = 0
        self.arr_log: list[float] = []  # arrival time of each COMPLETED request
        self.resp_log: list[float] = []  # matching response time
        self.n_arrived = 0
        self.qlen_integral = 0.0
        self.busy_time = 0.0
        self.last_t = float(t0)

    @property
    def n_up(self) -> int:
        """Effective capacity: configured servers minus crashed containers.
        This is what dispatch uses; ``n_servers`` stays the lifecycle-managed
        (configured + ramped) count so crashes and ramps compose."""
        d = self.down
        return self.n_servers - d if d < self.n_servers else 0

    def next_service(self) -> float:
        if self._svc_pos >= self._svc_buf.shape[0]:
            self._svc_buf = _service_chunk(
                self.svc_rng, self.mu, self.service, self.h2_scv
            )
            self._svc_pos = 0
        v = self._svc_buf[self._svc_pos]
        self._svc_pos += 1
        return float(v)

    def advance(self, t: float) -> None:
        """Accumulate the piecewise-constant queue/busy integrals up to t."""
        dt = t - self.last_t
        if dt > 0.0:
            self.qlen_integral += len(self.queue) * dt
            self.busy_time += self.busy * dt
            self.last_t = t


class FleetSimulator:
    """Fleet of M/M/N_i (or M/H2/N_i) clusters with mid-run reconfiguration.

    ``engine`` selects the implementation behind one contract:

    * ``"event"`` (default, this class) — the heapq event loop, the reference
      oracle: exact FCFS dynamics at any instant.
    * ``"vector"`` — the Kiefer–Wolfowitz workload-vector fast path
      (``core/des_vector.py``): between reconfiguration points each cluster
      is a stationary segment simulated by a batched scan over pre-drawn
      variates. Same chunked CRN streams, ~20-100x the event throughput.

    Typical closed-loop use (the ScenarioRunner DES backend)::

        sim = FleetSimulator(seed=0)
        sim.add_app("app0", lam=8.0, mu=2.5, n_servers=5)
        sim.run_until(60.0)                       # epoch 0
        sim.configure("app0", lam=12.0, n_servers=7)   # policy re-planned
        snap = sim.snapshot("app0")               # occupancy-window start
        sim.run_until(120.0)                      # epoch 1
        epoch1 = sim.window_stats("app0", 60.0, 120.0, snap_start=snap)
        sim.drain()                               # complete in-flight work
        resp = sim.responses("app0", 60.0, 120.0)  # now drain-complete
    """

    engine = "event"

    def __new__(cls, seed: int = 0, engine: str = "event", **kw):
        if cls is FleetSimulator and engine != "event":
            if engine == "vector":
                from repro_torch.core.des_vector import VectorFleetSimulator

                return super().__new__(VectorFleetSimulator)
            raise ValueError(f"engine must be one of {_ENGINES}, got {engine!r}")
        return super().__new__(cls)

    def __init__(
        self,
        seed: int = 0,
        engine: str = "event",
        service: str = "exp",
        h2_scv: float = 4.0,
        arrival=None,
        lifecycle=None,
        failures=None,
        device=None,
    ):
        del device  # the event engine runs on the host
        validate_service(service, h2_scv)  # eager, single-source (arrivals.py)
        self.t = 0.0
        self.seed = int(seed)
        self.service = service
        self.h2_scv = float(h2_scv)
        self.arrival = parse_arrival(arrival)  # fleet default; per-app override
        self.lifecycle = parse_lifecycle(lifecycle)  # fleet default lifecycle
        self.failures = parse_failures(failures)  # fleet default failure model
        self._heap: list[tuple] = []  # (t, seq, kind, name, aux)
        self._seq = 0
        self._clusters: dict[str, _Cluster] = {}

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
        cl = _Cluster(
            name, lam, mu, n_servers,
            arr=ArrivalStream(spec, lam, self.seed, name, self.t),
            svc_rng=_stream(self.seed, name, 29),
            t0=self.t,
            service=self.service,
            h2_scv=self.h2_scv,
            lifecycle=lc,  # initial capacity is pre-provisioned (no ramp)
            fp=fp,
        )
        self._clusters[name] = cl
        self._push_arrival(cl)
        if fp is not None:
            self._push(fp.next_change(), _FAILURE, name, fp.gen)

    def _make_fp(self, name, failures, lc):
        """Per-app FailureProcess (None when failures are off — no stream is
        created, so the off path is byte-identical to the pre-failure engine).
        The process captures the app's own cold-start lag: repairs land at
        t_crash + repair + t_cold."""
        spec = self.failures if failures is None else parse_failures(failures)
        if not spec.active:
            return None
        return FailureProcess(spec, self.seed, name, self.t, t_cold=lc.t_cold)

    def configure(
        self,
        name: str,
        lam: float | None = None,
        mu: float | None = None,
        n_servers: int | None = None,
        warm_pool: int | None = None,
    ) -> None:
        """Reconfigure a cluster at the current instant, carrying in-flight
        work (see module docstring for the exact semantics). With a non-zero
        ``LifecycleSpec.t_cold`` a scale-up beyond the warm pool lands only
        after the cold-start lag (one pending ramp, superseded by the next
        configure); ``warm_pool`` retargets the keep-warm reserve."""
        cl = self._cluster(name)
        cl.advance(self.t)
        if lam is not None and float(lam) != cl.lam:
            cl.lam = float(lam)
            cl.version += 1  # supersede the pending arrival (memorylessness)
            cl.arr.set_lam(float(lam), self.t)
            self._push_arrival(cl)
        if mu is not None and float(mu) != cl.mu_base:
            if mu <= 0:
                raise ValueError(f"app {name!r}: mu must be > 0")
            cl.mu_base = float(mu)  # the configured rate
            frac = cl.fp.spec.straggler_frac if (cl.fp is not None and cl.fp.slow) else 1.0
            cl.mu = cl.mu_base * frac  # in-service requests keep their old draw
            cl._svc_buf = np.empty(0)
        if n_servers is not None or warm_pool is not None:
            settle_pending(cl, self.t)  # idempotent (the heap normally did it)
            n0 = cl.n_servers
            cl.n_servers, cl.warm_avail, cl.warm_target, cl.pending = plan_capacity(
                self.t, cl.n_servers, cl.warm_avail, cl.warm_target,
                cl.lc.t_cold, n_servers, warm_pool,
            )
            cl.cap_version += 1  # any in-flight ramp event is now stale
            if cl.pending is not None:
                self._push(cl.pending[0], _CAPACITY, cl.name, cl.cap_version)
            if cl.n_servers > n0:
                self._start_queued(cl)  # instant growth picks up waiting work NOW

    def retire(self, name: str) -> None:
        """Disable arrivals; the cluster drains its queue and in-flight work."""
        cl = self._cluster(name)
        cl.advance(self.t)
        cl.active = False
        cl.version += 1  # cancel the pending arrival event
        cl.arr.deactivate()

    def activate(self, name: str) -> None:
        """Re-enable arrivals on a retired cluster (a tenant re-joining)."""
        cl = self._cluster(name)
        if cl.active:
            return
        cl.advance(self.t)
        cl.active = True
        cl.version += 1
        cl.arr.reactivate(self.t)
        self._push_arrival(cl)

    def apps(self) -> list[str]:
        return list(self._clusters)

    # ------------------------------------------------------------- event loop
    def run_until(self, t_end: float) -> None:
        """Process every event with t <= t_end; leaves the clock at t_end."""
        heap = self._heap
        clusters = self._clusters
        while heap and heap[0][0] <= t_end:
            t, _, kind, name, aux = heapq.heappop(heap)
            cl = clusters.get(name)
            if cl is None:
                continue
            if kind == _FAILURE and (cl.fp is None or aux != cl.fp.gen):
                continue  # superseded BEFORE the clock moves (drain safety)
            self.t = t
            if kind == _ARRIVAL:
                if aux != cl.version or not cl.active:
                    continue  # superseded by a reconfig/retire
                cl.advance(t)
                cl.n_arrived += 1
                cl.arr.pop()  # consume this arrival; draws the next pending
                self._push_arrival(cl)
                if cl.busy < cl.n_up:
                    cl.busy += 1
                    self._push_depart(cl, t_arr=t)
                else:
                    cl.queue.append(t)
            elif kind == _DEPART:
                cl.advance(t)
                cl.busy -= 1
                cl.arr_log.append(aux)
                cl.resp_log.append(t - aux)
                self._start_queued(cl)
            elif kind == _CAPACITY:  # capacity ramp landing (cold ready)
                if aux != cl.cap_version:
                    continue  # superseded by a later configure
                cl.advance(t)
                if settle_pending(cl, t):
                    self._start_queued(cl)
            else:  # _FAILURE: crash or repair instant from the fp stream
                cl.advance(t)
                self._apply_failure(cl, t)
        if np.isfinite(t_end):
            self.t = max(self.t, t_end)

    def drain(self) -> None:
        """Stop all arrivals and run the fleet until every admitted request
        has completed (so window stats never truncate slow responses). New
        crashes halt too — else a finite-MTBF fleet never runs out of events —
        but pending repairs still land, so work stranded by a crash completes
        once its replacement boots."""
        for cl in self._clusters.values():
            cl.version += 1  # cancel pending arrivals; active flag untouched
            if cl.fp is not None:
                cl.fp.halt()  # stop new crashes; supersedes the queued event
                t_next = cl.fp.next_change()
                if np.isfinite(t_next):  # pending repairs still land
                    self._push(t_next, _FAILURE, cl.name, cl.fp.gen)
        self.run_until(np.inf)

    # --------------------------------------------------------------- failures
    def crash(self, name: str, k: int = 1) -> None:
        """Scripted crash: take ``k`` healthy containers down NOW (bounded by
        what is up). Non-preemptive — in-flight requests complete; capacity
        returns only via ``repair()``. Backs the ``ContainerCrash`` scenario
        event; independent of any stochastic FailureProcess."""
        cl = self._cluster(name)
        cl.advance(self.t)
        cl.down += min(int(k), cl.n_up)

    def repair(self, name: str, k: int = 1) -> None:
        """Scripted repair: bring ``k`` crashed containers back NOW (bounded
        at zero down). Queued work is picked up immediately."""
        cl = self._cluster(name)
        cl.advance(self.t)
        up0 = cl.n_up
        cl.down = max(cl.down - int(k), 0)
        if cl.n_up > up0:
            self._start_queued(cl)

    def downs(self) -> dict[str, int]:
        """Crashed-and-not-yet-repaired container count per app — the crash
        notification surface the ScenarioRunner forwards to failover policies."""
        return {nm: cl.down for nm, cl in self._clusters.items()}

    def failure_stats(self) -> dict[str, dict]:
        """Per-app FailureProcess counters (apps with stochastic failures)."""
        return {
            nm: cl.fp.stats()
            for nm, cl in self._clusters.items()
            if cl.fp is not None
        }

    def _apply_failure(self, cl: _Cluster, t: float) -> None:
        """Land every fp event due at t, then reschedule. Shared by the event
        loop; the vector engine applies the same fp records segment-side."""
        fp = cl.fp
        up0 = cl.n_up
        out = fp.apply_at(t, up0)
        fp.gen += 1  # the queued event for the old schedule is now stale
        t_next = fp.next_change()
        if np.isfinite(t_next):
            self._push(t_next, _FAILURE, cl.name, fp.gen)
        if out["d_down"]:
            cl.down = max(cl.down + out["d_down"], 0)
        if not fp.spec.crash_mode:
            mu_eff = cl.mu_base * (fp.spec.straggler_frac if fp.slow else 1.0)
            if mu_eff != cl.mu:
                cl.mu = mu_eff  # in-service requests keep their old draw
                cl._svc_buf = np.empty(0)
        if cl.n_up > up0:
            self._start_queued(cl)  # a repair picks up waiting work NOW

    # -------------------------------------------------------------- internals
    def _cluster(self, name: str) -> _Cluster:
        try:
            return self._clusters[name]
        except KeyError:
            raise KeyError(
                f"unknown app {name!r}; simulated: {', '.join(self._clusters)}"
            ) from None

    def _push(self, t: float, kind: int, name: str, aux) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, kind, name, aux))

    def _push_arrival(self, cl: _Cluster) -> None:
        t_next = cl.arr.peek()  # the stream's single drawn-ahead arrival
        if cl.active and t_next is not None:
            self._push(t_next, _ARRIVAL, cl.name, cl.version)

    def _push_depart(self, cl: _Cluster, t_arr: float) -> None:
        self._push(self.t + cl.next_service(), _DEPART, cl.name, t_arr)

    def _start_queued(self, cl: _Cluster) -> None:
        while cl.queue and cl.busy < cl.n_up:
            t_arr = cl.queue.popleft()
            cl.busy += 1
            self._push_depart(cl, t_arr=t_arr)

    # ------------------------------------------------------------------ stats
    def snapshot(self, name: str) -> tuple[float, float]:
        """(qlen_integral, busy_time) extrapolated to the current clock —
        difference two snapshots to integrate over a measurement window."""
        cl = self._cluster(name)
        dt = max(self.t - cl.last_t, 0.0)
        return cl.qlen_integral + len(cl.queue) * dt, cl.busy_time + cl.busy * dt

    def responses(self, name: str, t_start: float, t_end: float) -> np.ndarray:
        """Response times of completed requests that ARRIVED in
        [t_start, t_end) — run ``drain()`` first to avoid truncating the
        window's slowest responses."""
        cl = self._cluster(name)
        arr = np.asarray(cl.arr_log, dtype=float)
        resp = np.asarray(cl.resp_log, dtype=float)
        mask = (arr >= t_start) & (arr < t_end)
        return resp[mask]

    def mean_response(self, names: Sequence[str], t_start: float, t_end: float):
        """Pooled mean response over several clusters — one fleet node's apps
        viewed as a unit (the placement-validation hook). Returns
        (mean_s, n_completed); (nan, 0) when nothing completed in the window.
        The vector engine overrides this with a log-sum that skips the
        per-cluster array concatenation."""
        chunks = [self.responses(nm, t_start, t_end) for nm in names]
        resp = np.concatenate(chunks) if chunks else np.empty(0)
        if resp.size == 0:
            return float("nan"), 0
        return float(np.mean(resp)), int(resp.size)

    def window_stats(
        self,
        name: str,
        t_start: float,
        t_end: float,
        snap_start: tuple[float, float] | None = None,
    ) -> SimStats:
        """SimStats for one cluster over [t_start, t_end). The response-time
        fields are exact for the window (mask on arrival time). The occupancy
        integrals (mean_queue_len/utilization) additionally need a
        ``snapshot()`` taken at t_start AND the clock still at t_end — without
        ``snap_start`` they are reported as NaN rather than a silently
        mis-windowed full-history average."""
        cl = self._cluster(name)
        resp = self.responses(name, t_start, t_end)
        if snap_start is not None:
            q1, b1 = self.snapshot(name)
            q0, b0 = snap_start
            dur = max(t_end - t_start, 1e-9)
            n_srv = max(cl.n_servers, 1)
            qlen = (q1 - q0) / dur
            util = (b1 - b0) / (dur * n_srv)
        else:
            qlen = util = float("nan")
        return SimStats(
            n_completed=int(resp.shape[0]),
            mean_response_s=float(np.mean(resp)) if resp.size else float("nan"),
            p95_response_s=float(np.percentile(resp, 95)) if resp.size else float("nan"),
            mean_queue_len=qlen,
            utilization=util,
        )


# ----------------------------------------------------------------------------
# Fleet placement validation: DES over a sampled subset of nodes
# ----------------------------------------------------------------------------
def validate_placement_sample(
    samples,
    *,
    horizon_s: float = 60.0,
    seed: int = 0,
    engine: str = "vector",
    service: str = "exp",
    device=None,
) -> list[dict]:
    """Replay a SAMPLED subset of fleet nodes through the DES and compare the
    achieved per-node mean response against the Erlang-C prediction — the
    placement layer's closed-loop check (a full-fleet replay would cost more
    than the plan itself; a per-epoch sample keeps the model honest for the
    price of a few nodes).

    ``samples``: sequence of ``(node_id, entries)`` with ``entries`` a list of
    ``(app_name, lam, mu, n_servers)`` for the apps placed on that node. All
    sampled nodes run in ONE simulator under namespaced cluster ids
    (``"n{node}:{name}"``) — with ``engine="vector"`` every cluster lands in
    the same Kiefer–Wolfowitz segment scan, so the sample costs one batched
    sweep. Returns one record per node: predicted/achieved λ-weighted mean
    response, their relative gap (None when either is undefined), and the
    completed-request count."""
    from repro_torch.core.queueing import erlang_ws_np

    sim = FleetSimulator(seed=seed, engine=engine, service=service, device=device)
    for node, entries in samples:
        for name, lam, mu, n in entries:
            sim.add_app(f"n{node}:{name}", float(lam), float(mu), int(n))
    sim.run_until(float(horizon_s))
    sim.drain()
    out = []
    for node, entries in samples:
        names = [f"n{node}:{name}" for name, _, _, _ in entries]
        achieved, n_done = sim.mean_response(names, 0.0, float(horizon_s))
        lam = np.array([e[1] for e in entries], dtype=float)
        ws = np.array([erlang_ws_np(int(e[3]), float(e[1]), float(e[2])) for e in entries])
        predicted = (
            float(np.sum(lam * ws) / np.sum(lam)) if np.all(np.isfinite(ws)) else float("inf")
        )
        gap = (
            abs(achieved - predicted) / predicted
            if math.isfinite(predicted) and predicted > 0 and math.isfinite(achieved)
            else None
        )
        out.append(
            {
                "node": int(node),
                "predicted_s": predicted if math.isfinite(predicted) else None,
                "achieved_s": achieved if math.isfinite(achieved) else None,
                "gap_rel": gap,
                "n_completed": n_done,
            }
        )
    return out


# ----------------------------------------------------------------------------
# Single-cluster / single-allocation views (back-compat entry points)
# ----------------------------------------------------------------------------
def simulate_mmn(
    lam: float,
    mu: float,
    n_servers: int,
    horizon_s: float = 2000.0,
    warmup_s: float = 200.0,
    seed: int = 0,
    engine: str = "event",
    service: str = "exp",
    h2_scv: float = 4.0,
    arrival=None,
    device=None,
) -> SimStats:
    """Single M/M/N cluster (the B=1 fleet). Response time = wait + service.

    All statistics — the response log AND the queue/utilization integrals —
    exclude the [0, warmup_s) transient; arrivals inside the measurement
    window are always completed (post-horizon drain), never truncated."""
    sim = FleetSimulator(
        seed=seed, engine=engine, service=service, h2_scv=h2_scv, arrival=arrival,
        device=device,
    )
    sim.add_app("mmn", lam, mu, n_servers)
    sim.run_until(warmup_s)
    snap = sim.snapshot("mmn")
    sim.run_until(horizon_s)
    q1, b1 = sim.snapshot("mmn")
    sim.drain()
    resp = sim.responses("mmn", warmup_s, horizon_s)
    dur = max(horizon_s - warmup_s, 1e-9)
    stats = SimStats(
        n_completed=int(resp.shape[0]),
        mean_response_s=float(np.mean(resp)) if resp.size else float("nan"),
        p95_response_s=float(np.percentile(resp, 95)) if resp.size else float("nan"),
        mean_queue_len=(q1 - snap[0]) / dur,
        utilization=(b1 - snap[1]) / (dur * max(int(n_servers), 1)),
    )
    return stats


def simulate_allocation(apps, allocation, horizon_s=2000.0, warmup_s=200.0, seed=0,
                        engine="event", service="exp", h2_scv=4.0, arrival=None,
                        device=None):
    """Simulate every app cluster of an Allocation in ONE fleet loop;
    returns per-app SimStats (same order as ``apps``). ``device`` is the
    vector engine's (None: the CUDA device); the service rates are host
    floats either way."""
    from repro_torch.core.problem import service_rate

    sim = FleetSimulator(
        seed=seed, engine=engine, service=service, h2_scv=h2_scv, arrival=arrival,
        device=device,
    )
    for i, app in enumerate(apps):
        mu = float(service_rate(app, allocation.r_cpu[i], allocation.r_mem[i], "cpu"))
        sim.add_app(app.name, app.lam, mu, int(allocation.n[i]))
    sim.run_until(warmup_s)
    snaps = {a.name: sim.snapshot(a.name) for a in apps}
    sim.run_until(horizon_s)
    ends = {a.name: sim.snapshot(a.name) for a in apps}
    sim.drain()
    out = []
    dur = max(horizon_s - warmup_s, 1e-9)
    for i, app in enumerate(apps):
        resp = sim.responses(app.name, warmup_s, horizon_s)
        q0, b0 = snaps[app.name]
        q1, b1 = ends[app.name]
        out.append(
            SimStats(
                n_completed=int(resp.shape[0]),
                mean_response_s=float(np.mean(resp)) if resp.size else float("nan"),
                p95_response_s=float(np.percentile(resp, 95)) if resp.size else float("nan"),
                mean_queue_len=(q1 - q0) / dur,
                utilization=(b1 - b0) / (dur * max(int(allocation.n[i]), 1)),
            )
        )
    return out


@dataclasses.dataclass
class WorkloadPhase:
    """Piecewise-constant arrival rates for the quasi-dynamic demo."""

    t_start: float
    lam: Sequence[float]


def run_quasi_dynamic(
    apps,
    phases: Sequence[WorkloadPhase],
    allocator: Callable,
    phase_len: float = 500.0,
    seed: int = 0,
    engine: str = "event",
    device=None,
):
    """Replay a piecewise workload through ONE continuous fleet simulation;
    the allocator is consulted at each phase boundary (it may or may not
    re-optimize — the quasi-dynamic driver decides) and its chosen
    (n, r_cpu, r_mem) is applied as a mid-run reconfiguration, so in-flight
    work carries across the re-plan instead of restarting from empty.
    Returns per-phase dicts of mean response / allocation."""
    from repro_torch.core.problem import service_rate

    sim = FleetSimulator(seed=seed, engine=engine, device=device)
    windows = []
    for k, phase in enumerate(phases):
        phase_apps = [a.with_lam(l) for a, l in zip(apps, phase.lam)]
        alloc = allocator(phase_apps)
        t0 = k * phase_len
        for i, app in enumerate(phase_apps):
            mu = float(service_rate(app, alloc.r_cpu[i], alloc.r_mem[i], "cpu"))
            if k == 0:
                sim.add_app(app.name, app.lam, mu, int(alloc.n[i]))
            else:
                sim.configure(app.name, lam=app.lam, mu=mu, n_servers=int(alloc.n[i]))
        sim.run_until(t0 + phase_len)
        windows.append((phase, alloc, t0 + 0.2 * phase_len, t0 + phase_len))
    sim.drain()
    results = []
    for phase, alloc, w0, w1 in windows:
        mean_resp = []
        for a in apps:
            resp = sim.responses(a.name, w0, w1)
            mean_resp.append(float(np.mean(resp)) if resp.size else float("nan"))
        results.append(
            {
                "t": phase.t_start,
                "lam": list(phase.lam),
                "mean_response": mean_resp,
                "alloc_n": alloc.n.tolist(),
            }
        )
    return results
