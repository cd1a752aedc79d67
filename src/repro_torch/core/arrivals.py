"""Arrival processes for the fleet DES: Poisson and Markov-modulated (MMPP).

The paper's model (and every allocation CRMS produces) assumes Poisson
arrivals, but real edge workloads are bursty: serverless invocation traces
show heavy temporal correlation and flash crowds (arXiv 2408.07536), and
arrival *burstiness* — not the mean rate — dominates tail behaviour
(arXiv 2105.04995). This module is the arrival-side counterpart of the
``service="h2"`` knob: it defines the burstiness model, the CRN draw streams
both DES engines consume, and the estimators that fit the model to real
request logs.

Three layers:

* **ArrivalSpec** — a frozen, validated description of the arrival law.
  ``kind="poisson"`` is the paper's model; ``kind="mmpp"`` is an R-phase
  Markov-modulated Poisson process: a continuous-time modulating chain with
  mean sojourn ``sojourn[i]`` seconds in phase i and relative intensity
  ``rates[i]``, auto-normalized so that ``lam`` stays the LONG-RUN MEAN rate
  (``sum_i pi_i * rates[i] == 1`` under the chain's stationary law pi).
  ``mmpp2(burst, frac, cycle)`` builds the canonical two-phase flavour: a
  burst phase at ``burst``x the mean rate active ``frac`` of the time.

* **ArrivalStream** — the chunked common-random-number generator BOTH DES
  engines consume. An MMPP conditioned on its modulating chain is a Poisson
  process with piecewise-constant rate, so phase changes reuse the engines'
  exact λ-reconfiguration law: the pending arrival is superseded and redrawn
  from the boundary at the new phase rate (exact by memorylessness), from a
  fresh chunk. The event engine pulls one arrival at a time (``peek``/
  ``pop``); the vector engine pulls whole phase-conditioned segments
  (``times_until``) by the same cumsum-over-chunks recipe — both paths
  consume the SAME draws in the SAME order, so engine parity holds for bursty
  arrivals exactly as it does for Poisson. Draw streams: ``(seed, name, 17)``
  for inter-arrival gaps (the historical recipe, byte-identical for Poisson),
  ``(seed, name, 43)`` for the modulating chain (one exponential per sojourn,
  plus one routing uniform per transition when R > 2).

* **Estimation** — ``estimate_arrival(counts, bin_s)`` ingests per-bin
  request counts (the Azure-Functions per-minute invocation format) and
  returns the mean rate, the empirical index of dispersion for counts
  IDC(bin) = Var[N]/E[N], an interarrival-SCV proxy, and a threshold-fit
  MMPP2 spec (burst factor = mean rate of above-mean bins over the global
  mean; burst fraction and sojourn from the run-length of above-mean bins).
  ``idc_asymptotic``/``idc_at`` give the model IDC for round-trip checks.

``validate_service``/``parse_arrival`` are the single source of truth for
service/arrival spec validation — both ``FleetSimulator`` engines and the
``Scenario`` layer raise the same eager errors (DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np

_CHUNK = 4096  # batched RNG draw size (vectorized event batching)
ARRIVAL_KINDS = ("poisson", "mmpp")
SERVICE_KINDS = ("exp", "h2")


def _stream(seed: int, name: str, salt: int) -> np.random.Generator:
    """Deterministic per-(seed, app, purpose) RNG stream. Arrival streams use
    salt 17 and depend on (seed, name) ONLY, so two policies replaying the
    same scenario see identical arrival processes (common random numbers);
    the MMPP modulating chain uses salt 43 the same way."""
    key = np.frombuffer(name.encode("utf-8"), dtype=np.uint8)
    return np.random.default_rng([int(seed) & 0x7FFFFFFF, salt, *key.tolist()])


def h2_params(mu: float, scv: float) -> tuple[float, float, float]:
    """Balanced-means hyperexponential fit: (p, mu1, mu2) such that the
    mixture p·Exp(mu1) + (1-p)·Exp(mu2) has mean 1/mu and squared
    coefficient of variation ``scv`` (>= 1), with each branch contributing
    half the mean (p/mu1 = (1-p)/mu2)."""
    if scv < 1.0:
        raise ValueError(f"h2_scv must be >= 1 (got {scv}); scv=1 is exponential")
    if scv == 1.0:
        return 1.0, float(mu), float(mu)
    p = 0.5 * (1.0 + math.sqrt((scv - 1.0) / (scv + 1.0)))
    return p, 2.0 * p * mu, 2.0 * (1.0 - p) * mu


def validate_service(service: str, h2_scv: float = 4.0) -> None:
    """Single-source service-law validation for both DES engines and the
    Scenario layer: same check, same message, raised eagerly."""
    if service not in SERVICE_KINDS:
        raise ValueError(f"service must be one of {SERVICE_KINDS}, got {service!r}")
    if service == "h2":
        h2_params(1.0, h2_scv)  # validate scv early


# ----------------------------------------------------------------------------
# The spec
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Validated arrival-law description (shape only — ``lam`` stays the mean
    rate and comes from the App/cluster, so λ-reconfiguration and the drift
    trigger keep their meaning under bursty arrivals).

    kind    : "poisson" (the paper's model) or "mmpp".
    rates   : per-phase relative intensity; normalized at construction so the
              stationary mean is exactly 1 (``lam * rates[i]`` is phase i's
              absolute rate). At least one rate must be > 0; a zero rate is
              an off phase (interrupted Poisson process).
    sojourn : per-phase MEAN sojourn seconds (exponential holding times).
    switch  : optional (R, R) row-stochastic routing with zero diagonal;
              default: deterministic toggle for R == 2, uniform over the
              other phases for R > 2.
    phase0  : deterministic starting phase (CRN replays start identically).
    """

    kind: str = "poisson"
    rates: tuple = ()
    sojourn: tuple = ()
    switch: tuple = ()
    phase0: int = 0
    stationary: tuple = dataclasses.field(default=(), compare=False)

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(
                f"arrival kind must be one of {ARRIVAL_KINDS}, got {self.kind!r}"
            )
        if self.kind == "poisson":
            if self.rates or self.sojourn or self.switch:
                raise ValueError("poisson arrivals take no rates/sojourn/switch")
            object.__setattr__(self, "stationary", ())
            return
        rates = np.asarray(self.rates, dtype=float)
        sojourn = np.asarray(self.sojourn, dtype=float)
        R = rates.shape[0]
        if R < 2 or sojourn.shape[0] != R:
            raise ValueError(
                f"mmpp needs >= 2 phases with matching rates/sojourn lengths, "
                f"got {rates.shape[0]} rates / {sojourn.shape[0]} sojourns"
            )
        if np.any(rates < 0.0) or not np.any(rates > 0.0) or not np.all(np.isfinite(rates)):
            raise ValueError(
                "mmpp rates must be finite and >= 0 with at least one > 0"
            )
        if np.any(sojourn <= 0.0) or not np.all(np.isfinite(sojourn)):
            raise ValueError("mmpp sojourn times must be finite and > 0")
        P = self._switch_matrix(R)
        if not 0 <= int(self.phase0) < R:
            raise ValueError(f"phase0 must be in [0, {R}), got {self.phase0}")
        pi = _stationary(P, sojourn)
        mean = float(pi @ rates)
        if mean <= 0.0:
            raise ValueError("mmpp stationary mean rate is zero")
        object.__setattr__(self, "rates", tuple((rates / mean).tolist()))
        object.__setattr__(self, "sojourn", tuple(sojourn.tolist()))
        object.__setattr__(self, "phase0", int(self.phase0))
        object.__setattr__(self, "stationary", tuple(pi.tolist()))

    def _switch_matrix(self, R: int) -> np.ndarray:
        """Validated routing matrix (default toggle/uniform-over-others)."""
        if not self.switch:
            P = np.full((R, R), 1.0 / (R - 1))
            np.fill_diagonal(P, 0.0)
            return P
        P = np.asarray(self.switch, dtype=float)
        if P.shape != (R, R):
            raise ValueError(f"switch must be ({R}, {R}), got {P.shape}")
        if np.any(np.diag(P) != 0.0) or np.any(P < 0.0) or not np.allclose(
            P.sum(axis=1), 1.0
        ):
            raise ValueError("switch must be row-stochastic with zero diagonal")
        return P

    @property
    def n_phases(self) -> int:
        return max(len(self.rates), 1)

    def lam_hi_ratio(self) -> float:
        """Peak-phase rate relative to the mean — the top of the
        [λ_lo, λ_hi] uncertainty interval robust_crms provisions against
        (1.0 for Poisson: the interval collapses to the mean)."""
        return float(max(self.rates)) if self.kind == "mmpp" else 1.0

    def to_dict(self) -> dict:
        """JSON-safe description (``parse_arrival`` accepts it back)."""
        if self.kind == "poisson":
            return {"kind": "poisson"}
        out = {
            "kind": "mmpp",
            "rates": list(self.rates),
            "sojourn": list(self.sojourn),
            "phase0": self.phase0,
        }
        if self.switch:
            out["switch"] = [list(row) for row in self.switch]
        return out


POISSON = ArrivalSpec()


def _stationary(P: np.ndarray, sojourn: np.ndarray) -> np.ndarray:
    """Stationary law of the modulating CTMC (routing P, mean sojourns T):
    generator Q = diag(1/T)(P - I); solve pi Q = 0, sum pi = 1."""
    R = P.shape[0]
    Q = (P - np.eye(R)) / sojourn[:, None]
    A = np.vstack([Q.T, np.ones(R)])
    b = np.zeros(R + 1)
    b[-1] = 1.0
    pi, *_ = np.linalg.lstsq(A, b, rcond=None)
    pi = np.clip(pi, 0.0, None)
    return pi / pi.sum()


def mmpp2(burst: float, frac: float, cycle: float, phase0: int = 0) -> ArrivalSpec:
    """Canonical two-phase MMPP: a burst phase at ``burst``x the mean rate,
    active a ``frac`` fraction of the time, with mean burst sojourn
    ``frac * cycle`` seconds (``cycle`` = mean low+burst round trip). The low
    phase absorbs the remaining intensity: rate (1 - frac*burst)/(1 - frac),
    which must stay >= 0 — i.e. ``burst * frac < 1``."""
    if burst < 1.0:
        raise ValueError(f"burst factor must be >= 1, got {burst}")
    if not 0.0 < frac < 1.0:
        raise ValueError(f"burst fraction must be in (0, 1), got {frac}")
    if cycle <= 0.0:
        raise ValueError(f"cycle must be > 0 seconds, got {cycle}")
    if burst * frac >= 1.0:
        raise ValueError(
            f"burst*frac must be < 1 (got {burst}*{frac}={burst * frac:.3f}); "
            "the low phase would need a negative rate"
        )
    if burst == 1.0:
        # degenerate: both phases at the mean rate — still an MMPP (the chain
        # consumes its draws) but statistically Poisson
        return ArrivalSpec(
            kind="mmpp", rates=(1.0, 1.0),
            sojourn=((1.0 - frac) * cycle, frac * cycle), phase0=phase0,
        )
    low = (1.0 - frac * burst) / (1.0 - frac)
    return ArrivalSpec(
        kind="mmpp",
        rates=(low, float(burst)),
        sojourn=((1.0 - frac) * cycle, frac * cycle),
        phase0=phase0,
    )


def parse_arrival(spec) -> ArrivalSpec:
    """Normalize any accepted arrival-spec shape — None, "poisson", an
    ArrivalSpec, or a ``to_dict()``-style mapping — to a validated
    ArrivalSpec. The single entry point both DES engines and the Scenario
    layer use, so invalid specs fail eagerly with the same message."""
    if spec is None or (isinstance(spec, str) and spec == "poisson"):
        return POISSON
    if isinstance(spec, ArrivalSpec):
        return spec
    if isinstance(spec, str):
        raise ValueError(f"arrival kind must be one of {ARRIVAL_KINDS}, got {spec!r}")
    if isinstance(spec, Mapping):
        kind = spec.get("kind", "poisson")
        if kind not in ARRIVAL_KINDS:
            raise ValueError(f"arrival kind must be one of {ARRIVAL_KINDS}, got {kind!r}")
        if kind == "poisson":
            return POISSON
        return ArrivalSpec(
            kind="mmpp",
            rates=tuple(spec.get("rates", ())),
            sojourn=tuple(spec.get("sojourn", ())),
            switch=tuple(tuple(row) for row in spec.get("switch", ())),
            phase0=int(spec.get("phase0", 0)),
        )
    raise TypeError(f"cannot parse arrival spec from {type(spec).__name__}")


# ----------------------------------------------------------------------------
# The CRN stream both engines consume
# ----------------------------------------------------------------------------
_EMPTY = np.empty(0)


class ArrivalStream:
    """Chunked arrival-time generator with exactly ONE drawn-ahead pending
    arrival — the invariant both DES engines already kept for Poisson,
    generalized per phase. All phase changes earlier than ``pending_t`` are
    resolved eagerly, so ``pending_t`` is always the true next arrival and
    the modulating state is current as of any instant <= ``pending_t``.

    Poisson consumption is byte-identical to the historical recipe (chunked
    ``rng.exponential(1/lam, size=_CHUNK)``), so seeded Poisson results are
    unchanged. Phase boundaries replay the engines' λ-reconfiguration law:
    the pending draw is superseded, the chunk buffer is discarded (its draws
    belong to the old rate), and a fresh chunk is drawn at the new phase
    rate from the boundary instant."""

    __slots__ = (
        "spec", "lam", "active", "rng", "_buf", "_pos",
        "phase", "_t_phase", "_phase_rng", "_switch", "pending_t",
    )

    def __init__(self, spec: ArrivalSpec, lam: float, seed: int, name: str, t0: float):
        self.spec = parse_arrival(spec)
        self.lam = float(lam)
        self.active = True
        self.rng = _stream(seed, name, 17)
        self._buf = _EMPTY
        self._pos = 0
        if self.spec.kind == "mmpp":
            self._phase_rng = _stream(seed, name, 43)
            self._switch = self.spec._switch_matrix(self.spec.n_phases)
            self.phase = self.spec.phase0
            self._t_phase = float(
                t0 + self._phase_rng.exponential(self.spec.sojourn[self.phase])
            )
        else:
            self._phase_rng = None
            self._switch = None
            self.phase = 0
            self._t_phase = None
        self.pending_t: float | None = None
        self._draw_pending(float(t0))

    # ------------------------------------------------------------- internals
    def _rate(self) -> float:
        if self._t_phase is None:
            return self.lam
        return self.lam * self.spec.rates[self.phase]

    def _cross_phase(self) -> float:
        """Advance the modulating chain through its next transition; returns
        the boundary instant. Discards the gap buffer — its draws belong to
        the old phase rate (the λ-reconfiguration law)."""
        b = self._t_phase
        R = self.spec.n_phases
        if R == 2:
            self.phase = 1 - self.phase
        else:
            u = float(self._phase_rng.random())
            cdf = np.cumsum(self._switch[self.phase])
            self.phase = int(np.searchsorted(cdf, u, side="right"))
        self._t_phase = float(
            b + self._phase_rng.exponential(self.spec.sojourn[self.phase])
        )
        self._buf = _EMPTY
        self._pos = 0
        return b

    def _sync_phase(self, t_now: float) -> None:
        """Resolve transitions up to ``t_now`` (used when the stream was idle
        — retired, or λ was zero — while the chain kept evolving)."""
        while self._t_phase is not None and self._t_phase <= t_now:
            self._cross_phase()

    def _refill(self) -> None:
        self._buf = self.rng.exponential(1.0 / self._rate(), size=_CHUNK)
        self._pos = 0

    def _draw_pending(self, t_from: float) -> None:
        """Draw the next arrival after ``t_from``, resolving every phase
        boundary it crosses: a candidate past the boundary is superseded and
        redrawn from the boundary at the new phase rate."""
        if not self.active or self.lam <= 0.0:
            self.pending_t = None
            return
        while True:
            if self._t_phase is not None and self.spec.rates[self.phase] <= 0.0:
                t_from = self._cross_phase()  # off phase: no arrivals at all
                continue
            if self._pos >= self._buf.shape[0]:
                self._refill()
            g = self._buf[self._pos]
            self._pos += 1
            cand = t_from + g
            if self._t_phase is None or cand <= self._t_phase:
                self.pending_t = float(cand)
                return
            t_from = self._cross_phase()

    # ----------------------------------------------------- engine interface
    def peek(self) -> float | None:
        """The next arrival's absolute time (None when deactivated/λ=0)."""
        return self.pending_t

    def pop(self) -> float | None:
        """Consume the pending arrival and draw the next one — the event
        engine's per-arrival pull."""
        t = self.pending_t
        if t is not None:
            self._draw_pending(t)
        return t

    def times_until(self, t_end: float) -> np.ndarray:
        """All arrival times <= ``t_end``, consumed segment-by-segment with
        the chunked-cumsum recipe (phase-conditioned chunks); leaves the
        overshoot arrival pending — the vector engine's batched pull. Draw
        consumption is identical to the equivalent sequence of ``pop()``s."""
        if self.pending_t is None or self.pending_t > t_end:
            return _EMPTY
        chunks = []
        while self.pending_t is not None and self.pending_t <= t_end:
            lim = t_end if self._t_phase is None else min(t_end, self._t_phase)
            last = self.pending_t
            chunks.append(np.array([last]))
            while True:
                if self._pos >= self._buf.shape[0]:
                    self._refill()
                ts = last + np.cumsum(self._buf[self._pos:])
                k = int(np.searchsorted(ts, lim, side="right"))
                if k < ts.shape[0]:
                    chunks.append(ts[:k])
                    self._pos += k + 1
                    cand = float(ts[k])
                    break
                chunks.append(ts)
                self._pos = self._buf.shape[0]
                last = float(ts[-1])
            if self._t_phase is None or cand <= self._t_phase:
                self.pending_t = cand
            else:
                # the overshoot crossed a phase boundary: superseded — resume
                # the eager redraw law from the boundary
                self._draw_pending(self._cross_phase())
        return np.concatenate(chunks)

    def set_lam(self, lam: float, t_now: float) -> None:
        """λ reconfiguration at ``t_now``: the pending arrival is superseded
        by a fresh draw at the new rate (exact by memorylessness); the chunk
        buffer is discarded. The modulating phase is carried across the
        boundary untouched — the exact mid-burst hand-off."""
        self.lam = float(lam)
        self._buf = _EMPTY
        self._pos = 0
        self._sync_phase(t_now)
        self._draw_pending(t_now)

    def cancel_pending(self) -> None:
        """Discard the drawn-ahead arrival without deactivating — the drain
        law (the event engine cancels it via a version bump instead)."""
        self.pending_t = None

    def deactivate(self) -> None:
        """Stop arrivals; the consumed pending draw is discarded (both
        engines' retire law)."""
        self.active = False
        self.pending_t = None

    def reactivate(self, t_now: float) -> None:
        """Resume arrivals at ``t_now``: the modulating chain kept evolving
        while retired, so transitions are resolved up to now before the
        fresh pending draw."""
        if self.active:
            return
        self.active = True
        # the gap buffer is NOT discarded here: its draws are still valid for
        # the current phase rate (the historical Poisson recipe), and any
        # phase transition inside _sync_phase discards it anyway
        self._sync_phase(t_now)
        self._draw_pending(t_now)


# ----------------------------------------------------------------------------
# Model moments (round-trip checks + the robustness policy's inputs)
# ----------------------------------------------------------------------------
def idc_asymptotic(spec: ArrivalSpec, lam: float) -> float:
    """Asymptotic index of dispersion for counts, IDC(inf) = lim Var[N_t]/E[N_t]:
    1 for Poisson; 1 + (2/lam_bar) * pi Lam D Lam 1 for an MMPP with
    rate matrix Lam = diag(lam * rates) and deviation matrix D of the
    modulating generator Q (computed numerically for any phase count)."""
    if spec.kind != "mmpp":
        return 1.0
    R = spec.n_phases
    T = np.asarray(spec.sojourn)
    P = spec._switch_matrix(R)
    Q = (P - np.eye(R)) / T[:, None]
    pi = np.asarray(spec.stationary)
    lam_abs = float(lam) * np.asarray(spec.rates)
    lam_bar = float(pi @ lam_abs)
    Pi = np.outer(np.ones(R), pi)
    D = np.linalg.solve(Pi - Q, np.eye(R)) - Pi  # deviation matrix
    extra = 2.0 * float(pi @ (lam_abs * (D @ lam_abs)))
    return 1.0 + extra / lam_bar


def idc_at(spec: ArrivalSpec, lam: float, t: float) -> float:
    """IDC at a finite counting window ``t`` for the two-phase MMPP (closed
    form): IDC(t) = IDC(inf) - (IDC(inf) - 1) * (1 - e^(-qt)) / (qt) with
    q the total switching rate — what a bin-counted trace actually measures
    when the bin is not large against the modulating sojourns."""
    if spec.kind != "mmpp":
        return 1.0
    if spec.n_phases != 2:
        raise NotImplementedError("idc_at: closed form implemented for 2 phases")
    q = 1.0 / spec.sojourn[0] + 1.0 / spec.sojourn[1]
    idc_inf = idc_asymptotic(spec, lam)
    x = q * float(t)
    damp = 1.0 if x <= 0.0 else (1.0 - math.exp(-x)) / x
    return idc_inf - (idc_inf - 1.0) * damp


# ----------------------------------------------------------------------------
# Trace ingestion: per-bin counts -> (lam, IDC, fitted MMPP2)
# ----------------------------------------------------------------------------
def estimate_arrival(counts: Sequence[float], bin_s: float = 60.0) -> dict:
    """Estimate the arrival law from per-bin request counts (one window of an
    Azure-Functions-style per-minute invocation log).

    Returns ``{"lam", "idc", "scv", "spec"}``:

    * ``lam`` — mean rate [req/s].
    * ``idc`` — empirical index of dispersion for counts at the bin
      timescale, Var[N]/E[N] (1 for Poisson; grows with burstiness).
    * ``scv`` — interarrival-SCV proxy (= idc; exact for renewal processes
      in the large-window limit, a standard burstiness summary otherwise).
    * ``spec`` — threshold-fit ArrivalSpec: bins above the mean count form
      the burst phase (burst factor = their mean over the global mean;
      fraction = their share of bins; sojourn = their mean run length), an
      ``mmpp2`` when the trace is overdispersed, Poisson otherwise.
    """
    c = np.asarray(counts, dtype=float)
    if c.ndim != 1 or c.shape[0] < 2:
        raise ValueError(f"counts must be a 1-D series of >= 2 bins, got shape {c.shape}")
    if bin_s <= 0.0:
        raise ValueError(f"bin_s must be > 0, got {bin_s}")
    if np.any(c < 0.0) or not np.all(np.isfinite(c)):
        raise ValueError("counts must be finite and >= 0")
    mean = float(c.mean())
    lam = mean / float(bin_s)
    if mean <= 0.0:
        return {"lam": 0.0, "idc": float("nan"), "scv": float("nan"), "spec": POISSON}
    idc = float(c.var(ddof=1) / mean)
    burst_mask = c > mean
    n_burst = int(burst_mask.sum())
    if idc <= 1.15 or n_burst == 0 or n_burst == c.shape[0]:
        # within Poisson noise (or a flat/degenerate split): no burst phase
        return {"lam": lam, "idc": idc, "scv": idc, "spec": POISSON}
    frac = n_burst / c.shape[0]
    burst = float(c[burst_mask].mean() / mean)
    burst = min(burst, 0.95 / frac)  # keep the low phase's rate > 0
    # mean run length of consecutive burst bins -> burst sojourn
    edges = np.diff(burst_mask.astype(int))
    n_runs = int((edges == 1).sum()) + int(burst_mask[0])
    run_len = n_burst / max(n_runs, 1)
    cycle = run_len * float(bin_s) / frac  # sojourn_burst = frac * cycle
    if burst <= 1.0 + 1e-9:
        return {"lam": lam, "idc": idc, "scv": idc, "spec": POISSON}
    return {"lam": lam, "idc": idc, "scv": idc, "spec": mmpp2(burst, frac, cycle)}


def read_invocation_csv(path) -> dict[str, np.ndarray]:
    """Read an Azure-Functions-style invocation log: one row per function,
    leading non-numeric column(s) forming its id, then per-bin integer
    counts. Header rows (any row whose count columns fail to parse) are
    skipped. Returns {name: counts} preserving file order."""
    out: dict[str, np.ndarray] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cells = line.split(",")
            split = 0
            while split < len(cells):
                try:
                    float(cells[split])
                    break
                except ValueError:
                    split += 1
            if split == 0 or split >= len(cells):
                continue  # header or malformed row
            name = ":".join(cells[:split])
            out[name] = np.asarray([float(v) for v in cells[split:]], dtype=float)
    if not out:
        raise ValueError(f"no invocation rows parsed from {path}")
    return out
