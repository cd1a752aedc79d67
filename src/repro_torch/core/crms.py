"""CRMS — the paper's two-stage Container-based Resource Management Scheme (§V).

``algorithm1``  : Efficient Server Resource Management in Sufficient Resource
                  Condition (paper Algorithm 1): per-app SP1 convex solve +
                  SP2 integer argmin -> ideal configs c_i*, batched over apps
                  by the engine.
``crms``        : Algorithm 2: if the ideal demand violates the global budgets,
                  fix N* and solve convex P1; then greedy refinement that
                  builds ALL 2M neighbor moves (N_i ± 1) per iteration and
                  evaluates them in ONE batched interior-point solve
                  (engine.p1_solve_batch, grid-seeded through the
                  ``crms_grid`` kernel on the card), accepting the best
                  improving move.
``QuasiDynamicAllocator`` : view of the §V-B "quasi-dynamic" driver — the
                  behaviour itself lives in
                  ``repro_torch.api.quasidynamic.QuasiDynamicPolicy``.

Solver configuration flows through one frozen ``repro_torch.api.SolverOptions``.
Every solve leaves structured diagnostics (refinement iterations, accepted
moves, phase-1 rescued/masked rows, warm-vs-cold, wall-clock) in
``Allocation.meta["diagnostics"]``.

Beyond the paper: if P1 is infeasible at N* (the paper implicitly assumes it
is not), N is pre-trimmed greedily by largest resource footprint until a
feasible interior point exists.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.api.types import SolverOptions
from repro_torch.core import queueing
from repro_torch.core.batch_eval import evaluate_candidates
from repro_torch.core.engine import as_packed, ideal_configs_batch, p1_solve_batch
from repro_torch.core.perf_model import eq1_latency
from repro_torch.core.problem import Allocation, App, ServerCaps, evaluate, service_rate
from repro_torch.device import f64, resolve_device


@dataclasses.dataclass
class IdealConfig:
    r_cpu: float
    r_mem: float
    n: int
    mu: float


def algorithm1(apps: Sequence[App], caps: ServerCaps, alpha: float, beta: float,
               device=None):
    """Paper Algorithm 1 — per-app ideal configs under sufficient resources.
    The SP1 bisection and SP2 argmin run batched over all apps at once."""
    c_star, m_star, n_star, mu_star = ideal_configs_batch(
        as_packed(apps), caps, alpha, beta, device=device
    )
    return [
        IdealConfig(r_cpu=float(c), r_mem=float(m), n=int(n), mu=float(mu))
        for c, m, n, mu in zip(c_star, m_star, n_star, mu_star)
    ]


def _stability_floor(app: App, r_cpu: float, r_mem: float, device=None) -> int:
    mu = float(service_rate(app, r_cpu, r_mem, device))
    return queueing.stability_lower_bound(app.lam, mu)


def _pretrim_n(apps, caps, n, ideal, device=None):
    """Decrement N until a feasible interior point for P1 can exist. Greedy on
    the largest (cpu-share + mem-share) footprint, respecting stability floors
    computed at the most favourable quota (the app's ideal one)."""
    n = np.asarray(n, dtype=int).copy()
    r_min = np.array([a.r_min for a in apps])
    floors = np.array(
        [_stability_floor(a, ic.r_cpu, a.r_max, device) for a, ic in zip(apps, ideal)]
    )
    for _ in range(int(np.sum(n)) + 1):
        mem_need = float(np.sum(n * r_min))
        if mem_need <= 0.97 * caps.r_mem:
            return n, True
        # largest mem footprint with slack above its floor
        order = np.argsort(-(n * r_min))
        moved = False
        for i in order:
            if n[i] > max(floors[i], 1):
                n[i] -= 1
                moved = True
                break
        if not moved:
            return n, False
    return n, False


def _rollout_refine_pick(
    apps, caps, packed, w, alpha, beta, tail_q, options, seed, cur, n, n_cands,
    batch, ref_mean, dev,
):
    """Score the incumbent allocation + all neighbor moves of one refinement
    iteration with ONE batched CRN DES rollout on ``dev`` (candidate 0 =
    incumbent) and return the best rollout-improving move as a packaged
    Allocation, or None when the incumbent wins every paired comparison.
    Guards: a move must be P1-converged, analytic-feasible/stable, AND keep
    the analytic λ-weighted mean latency within 2% of max(incumbent,
    ``ref_mean``) — ``ref_mean`` is the mean-quota reference the caller
    solved once, so the guard tracks the plain-Poisson mean-latency contract
    of ``crms_p95`` against what the mean-objective pipeline would deliver,
    not against a tail incumbent that happens to have bought extra CPU
    (DESIGN.md §14)."""
    from repro_torch.core.des_vector import rollout_candidates

    n_all = np.vstack([np.asarray(n, dtype=int)[None, :], np.asarray(n_cands, dtype=int)])
    c_all = np.vstack([np.asarray(cur.r_cpu, dtype=float)[None, :], np.asarray(batch.r_cpu)])
    m_all = np.vstack([np.asarray(cur.r_mem, dtype=float)[None, :], np.asarray(batch.r_mem)])
    ok = np.concatenate([[True], np.asarray(batch.converged, dtype=bool)])

    # analytic MEAN latency — feasibility mask + the 2% non-regression guard
    # (λ-weighted mean Ws, not utility: power growth is already priced into
    # the rollout score's β term, so the guard only protects mean latency)
    _, ws_mean, feas = evaluate_candidates(
        packed, caps, n_all.astype(float), c_all, m_all,
        alpha if w is None else alpha * w, beta, hard=True, device=dev,
    )
    lam_w = np.asarray(packed.lam, dtype=float)
    with np.errstate(invalid="ignore"):
        mean_lat = np.sum(lam_w[None, :] * ws_mean, axis=1) / np.sum(lam_w)
    guard = mean_lat[0] if not np.isfinite(ref_mean) else max(mean_lat[0], ref_mean)
    ok &= feas
    ok &= ~np.isnan(mean_lat) & (mean_lat <= guard * 1.02 + 1e-12)
    if not ok[0] or not np.any(ok[1:]):
        return None
    kap = f64(packed.kappa, dev)
    d_ms = eq1_latency((kap[:, 0], kap[:, 1], kap[:, 2]), f64(c_all, dev), f64(m_all, dev))
    mu_all = 1000.0 / (packed.xbar[None, :] * d_ms.cpu().numpy())
    # masked rows (unconverged P1) may carry garbage quotas; substitute the
    # incumbent's rates so rollout validation passes — their scores are inf
    bad = (~ok[:, None]) | ~np.isfinite(mu_all) | (mu_all <= 0.0)
    mu_all = np.where(bad, mu_all[0:1, :], mu_all)
    n_sim = np.where(~ok[:, None], n_all[0:1, :], n_all)

    horizon = float(options.rollout_horizon_s)
    ro = rollout_candidates(
        [a.name for a in apps], lam_w, mu_all, n_sim, horizon,
        seed=seed, warmup_s=0.2 * horizon, device=dev,
    )
    metric = ro.p95_s if tail_q else ro.mean_s
    aw = np.full(len(apps), float(alpha)) if w is None else float(alpha) * np.asarray(w, dtype=float)
    dp = caps.power.span * n_all * c_all / caps.r_cpu
    score = np.sum(aw[None, :] * metric + beta * dp / lam_w[None, :], axis=1)
    score = np.where(np.isfinite(score) & ok, score, np.inf)
    if not np.isfinite(score[0]):
        return None
    j = int(np.argmin(score[1:])) + 1
    if not score[j] < score[0] - 1e-12:
        return None
    cand = evaluate(
        apps, n_all[j], c_all[j], m_all[j], caps, alpha, beta, weights=w, tail_q=tail_q,
        device=dev,
    )
    if not (cand.feasible and cand.stable):
        return None
    cand.meta["rollout_score"] = float(score[j])
    return cand


def crms(
    apps: Sequence[App],
    caps: ServerCaps,
    alpha: float,
    beta: float,
    max_refine_iters: int = 64,
    solver=None,
    warm: Allocation | None = None,
    packed=None,
    newton: str = "structured",
    grid_seed: bool = True,
    options: SolverOptions | None = None,
    seed: int = 0,
    device=None,
) -> Allocation:
    """Paper Algorithm 2 (CRMS) on ``device``. Returns the final feasible
    Allocation.

    ``options``: a frozen SolverOptions carrying the whole solver
    configuration (newton mode, grid seeding, refinement budget, barrier
    schedule). When given it is authoritative; the ``max_refine_iters``/
    ``newton``/``grid_seed`` kwargs fold into an options object when it is
    None. ``options.tail_target`` swaps every α·Ws_i latency term for the
    analytic response-time quantile surrogate; ``options.rollout_budget``
    additionally lets refinement spend that many batched CRN DES rollout
    calls (des_vector.rollout_candidates, on ``device``) scoring its move
    batches by *achieved* p95 instead of the surrogate (DESIGN.md §14). Both
    ride the batched engine only — a serial ``solver`` override stays
    mean-objective. ``seed`` feeds the rollout CRN streams (ignored without
    a rollout budget).
    ``solver``: optional serial P1 solver override with the `p1_solve`
    signature; when None every P1 goes through the batched engine.
    ``warm``: a previous Allocation for the same app mix (quasi-dynamic
    execution). When usable, Algorithm 1 is skipped and refinement starts
    from the cached container counts.
    ``packed``: optional engine.PackedApps for ``apps`` built by the caller.
    """
    dev = resolve_device(device)
    if options is None:
        options = SolverOptions(
            newton=newton,
            grid_seed=grid_seed,
            max_refine_iters=max_refine_iters,
        )
    # Priority weighting (options.app_weights): the latency term becomes
    # α·w_i·Ws_i everywhere — Algorithm 1's ideal configs, every P1 interior
    # point, grid seeding, and the refinement acceptance objective.
    w = options.weight_vector([a.name for a in apps])
    alpha_w = alpha if w is None else alpha * w
    tail_q = float(options.tail_target)
    t_start = time.perf_counter()
    diag = {
        "warm_start": False,
        "refine_iters": 0,
        "accepted_moves": 0,
        "p1_calls": 0,
        "p1_rescued_rows": 0,
        "p1_masked_rows": 0,
        "rollout_calls": 0,
        "rollout_accepted": 0,
    }
    packed = packed if packed is not None else as_packed(apps)
    M = len(apps)

    def note_p1(info: dict):
        diag["p1_calls"] += 1
        diag["p1_rescued_rows"] += int(info.get("n_rescued", 0))
        diag["p1_masked_rows"] += int(info.get("n_masked", 0))

    def score(n_vec, c, m):
        return evaluate(apps, n_vec, c, m, caps, alpha, beta, weights=w, tail_q=tail_q,
                        device=dev)

    def solve_one(n_vec, c_hint):
        if solver is not None:
            res = solver(apps, caps, n_vec, alpha_w, beta, c_hint=c_hint)
            note_p1(res.info)
            return res
        batch = p1_solve_batch(
            packed, caps, np.asarray(n_vec, dtype=float)[None, :], alpha_w, beta,
            c_hint=c_hint, solver=options.newton, tail_q=tail_q, device=dev,
        )
        note_p1(batch.info)
        return batch.row(0)

    history = []
    ideal = None
    cur = None

    warm_ok = (
        warm is not None
        and len(warm.n) == M
        and np.all(np.asarray(warm.n) >= 1)
    )
    if warm_ok:
        n = np.asarray(warm.n, dtype=int).copy()
        c_hint = np.asarray(warm.r_cpu, dtype=float).copy()
        history.append({"stage": "warm_start", "n": n.tolist(), "U": float(warm.utility)})
        res = solve_one(n, c_hint)
        if res.converged:
            cand = score(n, res.r_cpu, res.r_mem)
            if cand.feasible and cand.stable:
                cur = cand
                history.append({"stage": "p1_warm", "n": n.tolist(), "U": res.utility})
            else:
                warm_ok = False
        else:
            warm_ok = False
    diag["warm_start"] = bool(warm_ok)

    if not warm_ok:
        ideal = algorithm1(apps, caps, alpha_w, beta, device=dev)
        n = np.array([ic.n for ic in ideal], dtype=int)
        c = np.array([ic.r_cpu for ic in ideal])
        m = np.array([ic.r_mem for ic in ideal])
        c_hint = c.copy()

        total_cpu = float(np.sum(n * c))
        total_mem = float(np.sum(n * m))
        over = total_cpu > caps.r_cpu or total_mem > caps.r_mem

        history.append({"stage": "algorithm1", "n": n.tolist(), "U": None})

        if over:
            n, ok = _pretrim_n(apps, caps, n, ideal, dev)
            res = solve_one(n, c_hint)
            if not res.converged:
                # fall back: keep trimming until P1 converges
                for _ in range(int(np.sum(n))):
                    floors = [max(_stability_floor(a, ch, a.r_max, dev), 1)
                              for a, ch in zip(apps, c_hint)]
                    cand = np.argsort(-(n * np.array([a.r_min for a in apps])))
                    moved = False
                    for i in cand:
                        if n[i] > floors[i]:
                            n[i] -= 1
                            moved = True
                            break
                    if not moved:
                        break
                    res = solve_one(n, c_hint)
                    if res.converged:
                        break
            if res.converged:
                c, m = res.r_cpu, res.r_mem
            history.append({"stage": "p1_initial", "n": n.tolist(), "U": res.utility})

        cur = score(n, c, m)
    else:
        over = True  # warm start implies the constrained regime was entered

    # Greedy refinement (Algorithm 2 lines 8-22). Beyond the paper: besides
    # N_i - 1 we also try N_i + 1 — the decomposition's SP1-then-SP2 ordering
    # can land below the joint optimum in N. All 2M neighbors of one
    # iteration are solved in a single batched P1 call.
    floors = np.array(
        [max(_stability_floor(apps[i], c_hint[i], apps[i].r_max, dev), 1) for i in range(M)]
    )
    rollout_ref_mean = np.inf
    if solver is None and options.rollout_budget > 0:
        # mean-quota reference for the rollout mean guard: what the paper's
        # mean objective would achieve at this N — solved once, not per move
        ref_batch = p1_solve_batch(
            packed, caps, np.asarray(n, dtype=float)[None, :], alpha_w, beta,
            c_hint=c_hint, profile=options.refine_profile, solver=options.newton,
            device=dev,
        )
        note_p1(ref_batch.info)
        if bool(np.asarray(ref_batch.converged)[0]):
            _, ws_ref, feas_ref = evaluate_candidates(
                packed, caps, np.asarray(n, dtype=float)[None, :],
                ref_batch.r_cpu, ref_batch.r_mem, alpha_w, beta, hard=True, device=dev,
            )
            lam_v = np.array([a.lam for a in apps], dtype=float)
            if bool(feas_ref[0]):
                rollout_ref_mean = float(np.sum(lam_v * ws_ref[0]) / np.sum(lam_v))
    for _ in range(options.max_refine_iters):
        moves = [
            (i, delta)
            for i in range(M)
            for delta in (-1, +1)
            if n[i] + delta >= floors[i]
        ]
        if not moves:
            break
        diag["refine_iters"] += 1
        best = None
        if solver is not None:
            for i, delta in moves:
                n_hat = n.copy()
                n_hat[i] += delta
                res = solver(apps, caps, n_hat, alpha_w, beta, c_hint=c_hint)
                note_p1(res.info)
                if not res.converged:
                    continue
                cand = score(n_hat, res.r_cpu, res.r_mem)
                if not (cand.feasible and cand.stable):
                    continue
                if best is None or cand.utility < best.utility:
                    best = cand
        else:
            n_cands = np.stack([n + delta * np.eye(M, dtype=int)[i] for i, delta in moves])
            # the "refine" barrier schedule; seed_grid puts grid-argmin hints
            # first, the SP1/warm c_hint and the waterfill stay in the
            # fallback chain, so seeding never shrinks the explorable move set
            batch = p1_solve_batch(
                packed, caps, n_cands, alpha_w, beta, c_hint=c_hint,
                profile=options.refine_profile,
                solver=options.newton, seed_grid=options.grid_seed, tail_q=tail_q,
                device=dev,
            )
            note_p1(batch.info)
            if options.rollout_budget > 0 and diag["rollout_calls"] < options.rollout_budget:
                # DES-scored refinement (DESIGN.md §14): ONE batched CRN
                # rollout ranks incumbent + all moves on achieved p95 (paired
                # comparison — shared draws, so short horizons are decisive).
                # The seed is fixed across iterations, making the rollout
                # objective a deterministic function of N: accepted moves
                # strictly decrease it, so the loop cannot cycle.
                diag["rollout_calls"] += 1
                picked = _rollout_refine_pick(
                    apps, caps, packed, w, alpha, beta, tail_q, options,
                    seed, cur, n, n_cands, batch, rollout_ref_mean, dev,
                )
                if picked is None:
                    break  # incumbent wins every paired comparison
                cur = picked
                n = picked.n.copy()
                diag["accepted_moves"] += 1
                diag["rollout_accepted"] += 1
                history.append(
                    {"stage": "greedy_rollout", "n": n.tolist(), "U": picked.utility}
                )
                continue
            u_cand, _, _ = evaluate_candidates(
                packed, caps, n_cands.astype(float), batch.r_cpu, batch.r_mem,
                alpha_w, beta, hard=True, tail_q=tail_q, device=dev,
            )
            u_cand = np.where(batch.converged, u_cand, np.inf)
            for j in np.argsort(u_cand):
                if not np.isfinite(u_cand[j]) or u_cand[j] >= cur.utility - 1e-12:
                    break
                cand = score(n_cands[j], batch.r_cpu[j], batch.r_mem[j])
                if cand.feasible and cand.stable:
                    best = cand
                    break
        if best is not None and best.utility < cur.utility - 1e-12:
            cur = best
            n = best.n.copy()
            diag["accepted_moves"] += 1
            history.append({"stage": "greedy", "n": n.tolist(), "U": best.utility})
        else:
            break

    # If the sufficient-resource config was feasible from the start, Algorithm 2
    # still applies P1 once over the fixed N* to tighten quotas under the caps.
    if not over:
        res = solve_one(n, c_hint)
        if res.converged:
            cand = score(n, res.r_cpu, res.r_mem)
            if cand.feasible and cand.stable and cand.utility < cur.utility:
                cur = cand

    if w is not None:
        cur.meta["app_weights"] = {a.name: float(wi) for a, wi in zip(apps, w)}
    cur.meta["history"] = history
    if ideal is not None:
        cur.meta["ideal"] = [dataclasses.asdict(ic) for ic in ideal]
    diag["wall_clock_s"] = time.perf_counter() - t_start
    cur.meta["diagnostics"] = diag
    return cur


class QuasiDynamicAllocator:
    """View of §V-B quasi-dynamic execution over CRMS.

    The caching/threshold behaviour lives in
    ``repro_torch.api.quasidynamic.QuasiDynamicPolicy`` — a decorator over ANY
    registered policy; this class pins it to the ``crms`` policy and keeps
    the `(apps, packed=) -> Allocation` call signature."""

    def __init__(
        self,
        caps: ServerCaps,
        alpha: float,
        beta: float,
        threshold: float = 0.15,
        newton: str = "structured",
        grid_seed: bool = True,
        options: SolverOptions | None = None,
        device=None,
    ):
        from repro_torch.api.quasidynamic import QuasiDynamicPolicy

        if options is None:
            options = SolverOptions(
                newton=newton,
                grid_seed=grid_seed,
                qd_threshold=threshold,
            )
        self.caps = caps
        self.alpha = alpha
        self.beta = beta
        self.options = options
        self.device = device
        self.threshold = options.qd_threshold
        self._qd = QuasiDynamicPolicy("crms", threshold=options.qd_threshold)

    @property
    def reoptimizations(self) -> int:
        return self._qd.reoptimizations

    def _request(self, apps: Sequence[App], packed=None):
        from repro_torch.api.types import AllocRequest

        return AllocRequest(
            apps=apps, caps=self.caps, alpha=self.alpha, beta=self.beta,
            packed=packed, options=self.options, device=self.device,
        )

    def should_reoptimize(self, apps: Sequence[App]) -> bool:
        return self._qd.should_reoptimize(self._request(apps))

    def allocate(self, apps: Sequence[App], packed=None) -> Allocation:
        return self._qd.allocate(self._request(apps, packed=packed)).allocation
