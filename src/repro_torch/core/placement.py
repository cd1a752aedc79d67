"""Fleet-of-fleets placement layer: apps across N nodes, one CRMS-style
inner allocation per node, all inner solves in ONE batched call.

The paper is intra-node — one server, M apps. Real edge deployments place
apps *across* nodes first (arXiv 2305.13732, 2408.07536) and only then let
CRMS split each node's CPU/memory. This module adds that outer layer without
a second solver: every candidate placement is scored by stacking all nodes'
P1 problems into a row batch — per-node packed-field stacks of shape
(N, M_pad[, 3]) plus per-node (caps_cpu, caps_mem) budgets — and calling
``engine.ip_solve_rows`` on ``device`` (None: the CUDA device). The row
operands are built with NumPy and go to the device in one transfer per
solve; the results come back in one.

Three invariants keep re-plans cheap:

pow2 sentinel padding (node axis)
    Heterogeneous per-node app counts are padded to one static ``M_pad``
    with masked sentinel slots (``mask`` = 0, n = 0, box-center quotas), and
    the row batch to a power of two with donor copies of row 0, so fleet
    shapes repeat. The masked interior point freezes sentinel coordinates —
    padded rows match standalone solves to fp precision.
narrow Erlang width
    Every Erlang-C logsumexp is narrowed from queueing.MAX_SERVERS (512) to
    the pow2 ceiling of the fleet's largest container count — EXACT, and
    64x less work at width 8.
incremental re-scoring
    ``replan`` re-solves ONLY the nodes touched by a λ change or migration,
    warm-hinted from the current solution; untouched nodes keep their
    allocations verbatim. Invariant: a node's inner solution depends only on
    its own app set and budgets, so the untouched rows are exactly what a
    cold solve would reproduce (no exchange runs during incremental plans).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import queueing
from repro_torch.core.engine import (
    P1_PROFILES,
    PackedApps,
    _eq1_np,
    _pad_pow2,
    as_packed,
    find_feasible_start_batch,
    ideal_configs_batch,
    ip_solve_rows,
)
from repro_torch.core.problem import App, ServerCaps
from repro_torch.device import f64, resolve_device

# Sentinel app parameters for masked padding slots: any strictly-positive,
# well-conditioned box works (the solver freezes these coordinates and masks
# every term they produce); these match the PackedApps defaults ballpark.
_SENTINEL = dict(
    kappa=(1.0, 1.0, 1.0), lam=1e-3, xbar=1.0,
    r_min=0.5, r_max=2.0, cpu_min=0.05, cpu_max=16.0,
)

_ACCEPT_TOL = 1e-9  # exchange move acceptance margin (sum of pair utilities)


@dataclasses.dataclass
class FleetPlan:
    """One placement + inner-allocation snapshot for the whole fleet."""

    assignment: np.ndarray  # (A,) int node id per app
    n: np.ndarray  # (A,) int container counts
    r_cpu: np.ndarray  # (A,) per-container CPU quota
    r_mem: np.ndarray  # (A,) per-container memory [GB]
    ws: np.ndarray  # (A,) per-app response time [s]
    node_utility: np.ndarray  # (N,) per-node P1 objective (inf if failed)
    node_ok: np.ndarray  # (N,) bool — node solved to a feasible allocation
    utility: float  # Σ over ok nodes
    diagnostics: dict


def make_fleet(
    n_nodes: int,
    apps_per_node: int,
    seed: int = 0,
    hetero: bool = True,
):
    """Synthetic fleet generator shared by the benchmark, tests and the
    fleet scenarios: ``n_nodes * apps_per_node`` heterogeneous apps plus
    per-node capacity draws sized so a balanced placement is comfortably
    feasible. Returns (apps, node_caps) with node_caps a list of (cpu, mem)."""
    rng = np.random.default_rng(seed)
    A = n_nodes * apps_per_node
    apps = [
        App(
            name=f"app{i:05d}",
            lam=float(rng.uniform(5.0, 30.0)),
            xbar=float(rng.uniform(0.5, 2.0)),
            kappa=(
                float(rng.uniform(5.0, 20.0)),
                float(rng.uniform(0.5, 2.0)),
                float(rng.uniform(0.5, 3.0)),
            ),
            r_min=float(rng.uniform(0.5, 1.0)),
            r_max=float(rng.uniform(2.0, 4.0)),
        )
        for i in range(A)
    ]
    if hetero:
        cpu = rng.uniform(7.0, 10.0, size=n_nodes) * apps_per_node
        mem = rng.uniform(9.0, 13.0, size=n_nodes) * apps_per_node
    else:
        cpu = np.full(n_nodes, 8.0 * apps_per_node)
        mem = np.full(n_nodes, 11.0 * apps_per_node)
    node_caps = [(float(c), float(m)) for c, m in zip(cpu, mem)]
    return apps, node_caps


class FleetPlanner:
    """fleet_of_fleets: outer placement (greedy + exchange) over batched
    per-node P1 inner solves.

    The outer loop mirrors the CRMS 2M-neighbor refinement shape one level
    up: the "move set" is app migrations between the worst-utility nodes and
    the most-headroom nodes, every candidate scored by re-solving ONLY the
    touched (src, dst) row pair, and moves accepted greedily when the pair's
    summed utility improves.

    Every solve runs on ``device`` (None: the CUDA device, RuntimeError
    without one). One device only: a ``mesh`` raises NotImplementedError.
    """

    def __init__(
        self,
        apps: Sequence[App],
        node_caps: Sequence,
        alpha: float = 1.4,
        beta: float = 0.2,
        profile: str = "fleet",
        exchange_rounds: int = 2,
        exchange_width: int = 8,
        mesh=None,
        mesh_axis: str = "nodes",
        initial_assignment=None,
        seed: int = 0,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                f"FleetPlanner solves on one device; sharding the node rows over a "
                f"mesh (axis {mesh_axis!r}) is not available"
            )
        self.device = resolve_device(device)
        self.apps = list(apps)
        self.packed = PackedApps.from_apps(self.apps)
        self.A = len(self.apps)
        self.names = [a.name for a in self.apps]
        self._name_idx = {a.name: i for i, a in enumerate(self.apps)}
        caps_list = [
            (float(c.r_cpu), float(c.r_mem)) if isinstance(c, ServerCaps) else (float(c[0]), float(c[1]))
            for c in node_caps
        ]
        self.caps_cpu = np.asarray([c for c, _ in caps_list])
        self.caps_mem = np.asarray([m for _, m in caps_list])
        self.N = len(caps_list)
        self.power_span = float(
            node_caps[0].power.span
            if isinstance(node_caps[0], ServerCaps)
            else ServerCaps(1.0, 1.0).power.span
        )
        self.alpha, self.beta = float(alpha), float(beta)
        self.profile = profile
        self.n_outer, self.n_inner = P1_PROFILES[profile]
        self.exchange_rounds = int(exchange_rounds)
        self.exchange_width = int(exchange_width)
        self.seed = int(seed)
        self._initial_assignment = (
            None if initial_assignment is None else np.asarray(initial_assignment, dtype=int)
        )

        # Ideal configs at the fleet-mean budget: per-app (c*, m*, n*, mu*)
        # used for footprints, count seeds and stability floors. One batched
        # call over ALL apps — never per node.
        ref_caps = ServerCaps(float(self.caps_cpu.mean()), float(self.caps_mem.mean()))
        # n_cap bounds the SP2 sweep to counts a multi-tenant node can actually
        # host (a whole-node ceiling is meaningless when ~M apps share it)
        self.c_star, self.m_star, self.n_star, self.mu_star = ideal_configs_batch(
            self.packed, ref_caps, self.alpha, self.beta, n_cap=64, device=self.device
        )
        self.lam_ref = self.packed.lam.copy()
        self.lam = self.packed.lam.copy()
        floors = [
            queueing.stability_lower_bound(l, mu)
            for l, mu in zip(self.lam, self.mu_star)
        ]
        self.floors = np.asarray(floors, dtype=int)

        # Static slot count per node: pow2 of the heaviest node under the
        # initial placement, with room for one migration in (exchange and
        # scenario migrations add at most one app per node per round).
        self.assignment = self._greedy_assign()
        max_load = int(np.bincount(self.assignment, minlength=self.N).max())
        self.M_pad = _pad_pow2(max_load + 1)
        self.n = np.maximum(self.n_star.astype(int), self.floors)
        self._pretrim_counts()
        self._width = self._erlang_width()

        # Per-app solution state (scattered back from row solves)
        self.sol_c = np.zeros(self.A)
        self.sol_m = np.zeros(self.A)
        self.sol_ws = np.zeros(self.A)
        self._last_hint = np.full(self.A, np.nan)  # phase-1 hint actually used
        self.node_utility = np.full(self.N, np.inf)
        self.node_ok = np.zeros(self.N, dtype=bool)
        self._counters = {"p1_rescued_rows": 0, "p1_masked_rows": 0}

    # ------------------------------------------------------------------
    # placement construction
    # ------------------------------------------------------------------
    def _greedy_assign(self) -> np.ndarray:
        """Worst-fit decreasing on normalized ideal footprints: heaviest app
        first, always to the node with the most normalized headroom left.
        Lazy heap (stale entries re-pushed) keeps this O(A log N)."""
        if self._initial_assignment is not None:
            a = self._initial_assignment
            if a.shape != (self.A,) or a.min() < 0 or a.max() >= self.N:
                raise ValueError("initial_assignment must be (A,) node ids")
            return a.copy()
        import heapq

        cpu_need = np.maximum(self.n_star, 1) * self.c_star
        mem_need = np.maximum(self.n_star, 1) * np.maximum(self.m_star, self.packed.r_min)
        foot = cpu_need / self.caps_cpu.mean() + mem_need / self.caps_mem.mean()
        order = np.argsort(-foot)
        cpu_left = self.caps_cpu.copy()
        mem_left = self.caps_mem.copy()
        # heap of (-headroom, node); headroom re-derived on pop to skip stale
        heap = [(-min(cpu_left[j] / self.caps_cpu[j], mem_left[j] / self.caps_mem[j]), j) for j in range(self.N)]
        heapq.heapify(heap)
        assignment = np.zeros(self.A, dtype=int)
        for i in order:
            while True:
                neg_h, j = heapq.heappop(heap)
                h_now = min(cpu_left[j] / self.caps_cpu[j], mem_left[j] / self.caps_mem[j])
                if -neg_h - h_now > 1e-12:  # stale entry — re-push fresh
                    heapq.heappush(heap, (-h_now, j))
                    continue
                break
            assignment[i] = j
            cpu_left[j] -= cpu_need[i]
            mem_left[j] -= mem_need[i]
            h_new = min(cpu_left[j] / self.caps_cpu[j], mem_left[j] / self.caps_mem[j])
            heapq.heappush(heap, (-h_new, j))
        return assignment

    def _pretrim_counts(self, nodes=None):
        """Vectorized analogue of crms._pretrim_n across nodes: while a
        node's count vector cannot admit a feasible interior point (minimal
        memory footprint over budget), decrement the largest-footprint app
        with slack above its stability floor — one decrement per
        over-committed node per sweep, all nodes in parallel."""
        sub = np.arange(self.N) if nodes is None else np.asarray(sorted(nodes), dtype=int)
        if sub.size == 0:
            return
        r_min = self.packed.r_min
        for _ in range(int(self.n.max()) + 1):
            mem_need = np.bincount(
                self.assignment, weights=self.n * r_min, minlength=self.N
            )[sub]
            over = mem_need > 0.97 * self.caps_mem[sub]
            if not over.any():
                break
            foot = self.n * r_min
            slack = self.n > np.maximum(self.floors, 1)
            moved = False
            for j in sub[over]:
                on_j = np.where((self.assignment == j) & slack)[0]
                if on_j.size == 0:
                    continue  # phase-1 will mask this node as infeasible
                self.n[on_j[np.argmax(foot[on_j])]] -= 1
                moved = True
            if not moved:
                break

    def _erlang_width(self) -> int:
        w = _pad_pow2(max(int(self.n.max()) + 1, 8))
        # sticky: only grow, so λ wiggles around a pow2 boundary keep one
        # width (and the reference's results)
        prev = getattr(self, "_width", 0)
        return min(max(w, prev), queueing.MAX_SERVERS)

    # ------------------------------------------------------------------
    # row building + batched solve
    # ------------------------------------------------------------------
    def _node_slots(self, sub: np.ndarray) -> np.ndarray:
        """(len(sub), M_pad) app indices per node, -1 for sentinel slots."""
        slots = np.full((sub.size, self.M_pad), -1, dtype=int)
        pos_of = {int(j): k for k, j in enumerate(sub)}
        order = np.argsort(self.assignment, kind="stable")
        nodes_sorted = self.assignment[order]
        starts = np.searchsorted(nodes_sorted, np.arange(self.N))
        pos = np.arange(self.A) - starts[nodes_sorted]
        if pos.size and int(pos.max()) >= self.M_pad:
            raise ValueError(
                f"node over capacity: {int(pos.max()) + 1} apps > M_pad={self.M_pad}"
            )
        keep = np.isin(nodes_sorted, sub)
        rows = np.asarray([pos_of[int(j)] for j in nodes_sorted[keep]])
        slots[rows, pos[keep]] = order[keep]
        return slots

    def _build_rows(self, sub: np.ndarray):
        """Stack the sub-fleet's per-node problems into row-batch operands."""
        slots = self._node_slots(sub)
        mask = (slots >= 0).astype(float)
        safe = np.where(slots >= 0, slots, 0)

        def gather(field, sentinel):
            g = field[safe]
            shape = mask.shape + (1,) * (g.ndim - 2)
            return np.where(mask.reshape(shape) > 0, g, sentinel)

        rows = {
            "kappa": gather(self.packed.kappa, np.asarray(_SENTINEL["kappa"])),
            "lam": gather(self.lam, _SENTINEL["lam"]),
            "xbar": gather(self.packed.xbar, _SENTINEL["xbar"]),
            "r_min": gather(self.packed.r_min, _SENTINEL["r_min"]),
            "r_max": gather(self.packed.r_max, _SENTINEL["r_max"]),
            "cpu_min": gather(self.packed.cpu_min, _SENTINEL["cpu_min"]),
            "cpu_max": gather(self.packed.cpu_max, _SENTINEL["cpu_max"]),
        }
        n_rows = np.where(mask > 0, self.n[safe], 0).astype(float)
        return slots, mask, rows, n_rows

    def _solve_nodes(self, nodes) -> dict:
        """Re-solve the given nodes' inner P1 problems in one row batch and
        scatter the results into the per-app solution state. Returns counter
        deltas. Batch is pow2-padded with donor copies of row 0 so shrinking
        touched sets keep a few stable shapes."""
        sub = np.asarray(sorted(set(int(j) for j in nodes)))
        if sub.size == 0:
            return {"rows": 0, "rescued": 0, "masked": 0}
        slots, mask, rows, n_rows = self._build_rows(sub)

        pp = PackedApps(**{k: rows[k] for k in (
            "kappa", "lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")})
        caps = ServerCaps(self.caps_cpu[sub], self.caps_mem[sub])
        # warm hint: current per-app quotas where solved, ideal c* otherwise
        hint_app = np.where(self.sol_c > 0, self.sol_c, self.c_star)
        c_hint = np.where(mask > 0, hint_app[np.where(slots >= 0, slots, 0)], 1.0)
        x0, ok = find_feasible_start_batch(pp, caps, n_rows, c_hint=c_hint, mask=mask)
        live_slots = slots[mask > 0]
        self._last_hint[live_slots] = c_hint[mask > 0]
        rescued = 0
        if not ok.all():  # fall back to the plain waterfill, failing rows only
            idx = np.where(~ok)[0]
            self._last_hint[slots[idx][mask[idx] > 0]] = np.nan
            x0_fb, ok_fb = find_feasible_start_batch(
                PackedApps(**{k: getattr(pp, k)[idx] for k in (
                    "kappa", "lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max")}),
                ServerCaps(self.caps_cpu[sub][idx], self.caps_mem[sub][idx]),
                n_rows[idx], mask=mask[idx],
            )
            x0[idx[ok_fb]] = x0_fb[ok_fb]
            ok[idx[ok_fb]] = True
            rescued = int(ok_fb.sum())

        B = sub.size
        Bp = _pad_pow2(B)
        self._width = self._erlang_width()

        def pad(a):
            if Bp == B:
                return a
            return np.concatenate([a, np.broadcast_to(a[:1], (Bp - B,) + a.shape[1:])], 0)

        # every row operand in one host block: one transfer to the device
        M = self.M_pad
        names = ("lam", "xbar", "r_min", "r_max", "cpu_min", "cpu_max", "mask", "n")
        cols = ([x0, rows["kappa"].reshape(B, 3 * M)] + [rows[k] for k in names[:6]]
                + [mask, n_rows, np.stack([self.caps_cpu[sub], self.caps_mem[sub]], axis=1)])
        block = f64(pad(np.concatenate(cols, axis=1)), self.device)
        x0_d, kappa_d, *fields, caps_d = block.split([2 * M, 3 * M] + [M] * 8 + [2], dim=1)
        packed_rows = dict(zip(names, fields), kappa=kappa_d.reshape(Bp, M, 3))
        n_d = packed_rows.pop("n")
        x, u, ws = ip_solve_rows(
            x0_d,
            packed_rows,
            n_d,
            caps_d[:, 0],
            caps_d[:, 1],
            self.power_span,
            self.alpha,
            self.beta,
            n_outer=self.n_outer,
            n_inner=self.n_inner,
            width=self._width,
        )
        out = torch.cat([x, u[:, None], ws], dim=1).cpu().numpy()[:B]
        x, u, ws = out[:, : 2 * M], out[:, 2 * M], out[:, 2 * M + 1:]

        solved = ok & np.isfinite(u)
        self.node_utility[sub] = np.where(solved, u, np.inf)
        self.node_ok[sub] = solved
        live = (mask > 0) & solved[:, None]
        app_idx = slots[live]
        self.sol_c[app_idx] = x[:, : self.M_pad][live]
        self.sol_m[app_idx] = x[:, self.M_pad:][live]
        self.sol_ws[app_idx] = ws[live]
        masked = int(B - ok.sum())
        self._counters["p1_rescued_rows"] += rescued
        self._counters["p1_masked_rows"] += masked
        return {"rows": B, "rescued": rescued, "masked": masked}

    # ------------------------------------------------------------------
    # outer exchange refinement
    # ------------------------------------------------------------------
    def _headroom(self) -> np.ndarray:
        used_cpu = np.bincount(
            self.assignment, weights=self.n * self.sol_c, minlength=self.N
        )
        used_mem = np.bincount(
            self.assignment, weights=self.n * self.sol_m, minlength=self.N
        )
        return np.minimum(
            (self.caps_cpu - used_cpu) / self.caps_cpu,
            (self.caps_mem - used_mem) / self.caps_mem,
        )

    def _exchange(self) -> int:
        """Greedy-with-exchange refinement: per round, pick the worst-W nodes
        by utility (failed nodes first), move each one's highest-marginal-cost
        app to the max-headroom node, re-solve all touched (src, dst) pairs in
        one row batch, and accept each pair's move iff its summed utility
        improved. Node-disjoint moves make acceptance independent."""
        accepted_total = 0
        counts = np.bincount(self.assignment, minlength=self.N)
        for _ in range(self.exchange_rounds):
            # per-app marginal objective term at the current solution
            dp = self.power_span * self.n * self.sol_c / self.caps_cpu[self.assignment]
            marg = self.alpha * self.sol_ws + self.beta * dp / self.lam
            head = self._headroom()
            bad_first = np.where(self.node_ok, self.node_utility, np.inf)
            worst = np.argsort(-np.where(np.isfinite(bad_first), bad_first, 1e18))
            moves = []  # (app, src, dst)
            taken = set()
            for s in worst[: self.exchange_width]:
                s = int(s)
                if s in taken:
                    continue
                on_s = np.where(self.assignment == s)[0]
                if on_s.size <= 1:
                    continue
                a = int(on_s[np.argmax(np.where(self.node_ok[s], marg[on_s], self.n[on_s] * self.c_star[on_s]))])
                cand = np.argsort(-head)
                dst = next(
                    (int(d) for d in cand
                     if int(d) != s and int(d) not in taken
                     and counts[int(d)] + 1 < self.M_pad and self.node_ok[int(d)]),
                    None,
                )
                if dst is None:
                    continue
                moves.append((a, s, dst))
                taken.update((s, dst))
            if not moves:
                break
            snap_assign = self.assignment.copy()
            touched = [j for _, s, d in moves for j in (s, d)]
            snap = self._snapshot(touched)
            before = {(s, d): self._pair_u(s, d) for _, s, d in moves}
            for a, s, d in moves:
                self.assignment[a] = d
            self._solve_nodes(touched)
            accepted = []
            for a, s, d in moves:
                if self._pair_u(s, d) < before[(s, d)] - _ACCEPT_TOL:
                    accepted.append((a, s, d))
            if len(accepted) < len(moves):
                # revert rejected moves and restore their pair state; the
                # accepted pairs' freshly solved rows stay as-is
                rejected = [mv for mv in moves if mv not in accepted]
                for a, s, d in rejected:
                    self.assignment[a] = snap_assign[a]
                self._restore(snap, [j for _, s, d in rejected for j in (s, d)])
            for a, s, d in accepted:
                counts[s] -= 1
                counts[d] += 1
            accepted_total += len(accepted)
            if not accepted:
                break
        return accepted_total

    def _pair_u(self, s: int, d: int) -> float:
        us = self.node_utility[s] if self.node_ok[s] else 1e18
        ud = self.node_utility[d] if self.node_ok[d] else 1e18
        return float(us + ud)

    def _snapshot(self, nodes):
        uniq = sorted(set(int(j) for j in nodes))
        sel = np.isin(self.assignment, uniq)
        return {
            "nodes": uniq,
            "apps": np.where(sel)[0],
            "sol": (self.sol_c[sel].copy(), self.sol_m[sel].copy(), self.sol_ws[sel].copy()),
            "u": self.node_utility[uniq].copy(),
            "ok": self.node_ok[uniq].copy(),
            "n": self.n[sel].copy(),
        }

    def _restore(self, snap, nodes):
        nodes = set(int(j) for j in nodes)
        apps = snap["apps"]
        keep = np.isin(self.assignment[apps], list(nodes))
        # restore only apps whose (reverted) node is being rolled back
        idx = apps[keep]
        pos = np.where(keep)[0]
        self.sol_c[idx] = snap["sol"][0][pos]
        self.sol_m[idx] = snap["sol"][1][pos]
        self.sol_ws[idx] = snap["sol"][2][pos]
        self.n[idx] = snap["n"][pos]
        all_nodes = snap["nodes"]
        for k, j in enumerate(all_nodes):
            if j in nodes:
                self.node_utility[j] = snap["u"][k]
                self.node_ok[j] = snap["ok"][k]

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def plan(self) -> FleetPlan:
        """Cold plan: greedy assignment (already built), one full row-batch
        solve over all N nodes, then exchange refinement."""
        t0 = time.perf_counter()
        self._counters = {"p1_rescued_rows": 0, "p1_masked_rows": 0}
        self._solve_nodes(range(self.N))
        accepted = self._exchange() if self.exchange_rounds > 0 else 0
        return self._finish(t0, cold=True, nodes_solved=self.N,
                            migrations=0, exchange_accepted=accepted)

    def replan(self, lam=None, migrations=()) -> FleetPlan:
        """Incremental re-plan: update λ and/or apply migrations, re-solve
        ONLY the touched nodes (warm-hinted). No exchange pass — untouched
        rows must stay verbatim, which is the incremental invariant the
        fleet-smoke parity gate checks. A touched node that loses phase-1
        feasibility triggers container-granular emergency offload: up to 3
        deficit-covering migrations (smallest sufficient app first) to
        max-headroom nodes, re-solving each (source, destination) pair."""
        t0 = time.perf_counter()
        self._counters = {"p1_rescued_rows": 0, "p1_masked_rows": 0}
        touched: set = set()
        n_migrations = 0
        if lam is not None:
            lam_map = (
                lam if isinstance(lam, dict)
                else {self.names[i]: float(v) for i, v in enumerate(np.asarray(lam))}
            )
            for name, v in lam_map.items():
                i = self._name_idx[name]
                if float(v) == self.lam[i]:
                    continue
                self.lam[i] = float(v)
                floor = queueing.stability_lower_bound(self.lam[i], self.mu_star[i])
                self.floors[i] = floor
                scaled = int(round(self.n_star[i] * self.lam[i] / self.lam_ref[i]))
                self.n[i] = min(max(scaled, floor), queueing.MAX_SERVERS - 1)
                touched.add(int(self.assignment[i]))
        counts = np.bincount(self.assignment, minlength=self.N)
        for name, dst in migrations:
            i = self._name_idx[name]
            src, dst = int(self.assignment[i]), int(dst)
            if src == dst:
                continue
            if counts[dst] >= self.M_pad:
                raise ValueError(
                    f"migration of {name!r} to node {dst} exceeds M_pad={self.M_pad}"
                )
            self.assignment[i] = dst
            counts[src] -= 1
            counts[dst] += 1
            touched.update((src, dst))
            n_migrations += 1
        self._pretrim_counts(touched)
        self._solve_nodes(touched)
        # Emergency offload for touched nodes that lost feasibility —
        # container-granular: estimate the binding resource's deficit from
        # the per-app container footprints (n_i containers of quota c_i/m_i
        # each) and move the SMALLEST app whose departure covers it, not
        # blindly the largest-footprint one — the donor node keeps as much
        # of its working set as possible. When no single app covers the
        # deficit the largest goes first and the loop continues, spilling to
        # max-headroom destinations (possibly a different one per move),
        # bounded at 3 moves per node so a hopeless node cannot stall the
        # re-plan.
        bad = [j for j in touched if not self.node_ok[j]]
        for j in bad:
            for _ in range(3):
                if self.node_ok[j]:
                    break
                on_j = np.where(self.assignment == j)[0]
                if on_j.size <= 1:
                    break
                cpu_foot = self.n[on_j] * np.maximum(
                    self.sol_c[on_j], self.c_star[on_j]
                )
                mem_foot = self.n[on_j] * np.maximum(
                    self.m_star[on_j], self.packed.r_min[on_j]
                )
                cpu_def = float(cpu_foot.sum() - self.caps_cpu[j])
                # 0.97: the interior point needs strict slack (_pretrim_counts)
                mem_def = float(mem_foot.sum() - 0.97 * self.caps_mem[j])
                if mem_def / self.caps_mem[j] >= cpu_def / self.caps_cpu[j]:
                    foot, deficit = mem_foot, mem_def
                else:
                    foot, deficit = cpu_foot, cpu_def
                covering = np.where(foot >= deficit)[0] if deficit > 0 else []
                a = (
                    int(on_j[covering[np.argmin(foot[covering])]])
                    if len(covering)
                    else int(on_j[np.argmax(foot)])
                )
                head = self._headroom()
                head[j] = -np.inf
                cand = [
                    d for d in np.argsort(-head) if counts[int(d)] + 1 < self.M_pad
                ]
                if not cand:
                    break
                d = int(cand[0])
                self.assignment[a] = d
                counts[j] -= 1
                counts[d] += 1
                n_migrations += 1
                self._solve_nodes([j, d])
        return self._finish(t0, cold=False, nodes_solved=len(touched),
                            migrations=n_migrations, exchange_accepted=0)

    def _finish(self, t0, **extra) -> FleetPlan:
        util = float(np.sum(np.where(self.node_ok, self.node_utility, 0.0)))
        diags = {
            "nodes_total": self.N,
            "apps": self.A,
            "M_pad": self.M_pad,
            "width": self._width,
            "profile": self.profile,
            "wall_clock_s": time.perf_counter() - t0,
            "nodes_failed": int(np.sum(~self.node_ok)),
            **self._counters,
            **extra,
        }
        return FleetPlan(
            assignment=self.assignment.copy(),
            n=self.n.copy(),
            r_cpu=self.sol_c.copy(),
            r_mem=self.sol_m.copy(),
            ws=self.sol_ws.copy(),
            node_utility=self.node_utility.copy(),
            node_ok=self.node_ok.copy(),
            utility=util,
            diagnostics=diags,
        )

    # -- parity / validation helpers ----------------------------------
    def node_problem(self, j: int):
        """The node's standalone P1 problem (apps, ServerCaps, (1, M) counts,
        c_hint) in slot order — what tests feed to p1_solve_batch for parity.
        ``c_hint`` is the exact phase-1 hint the row solve used (None if the
        row fell back to the plain waterfill)."""
        on_j = [int(i) for i in np.where(self.assignment == j)[0]]
        apps = [self.apps[i].with_lam(float(self.lam[i])) for i in on_j]
        caps = ServerCaps(float(self.caps_cpu[j]), float(self.caps_mem[j]))
        hint = self._last_hint[on_j]
        c_hint = None if np.any(np.isnan(hint)) else hint[None, :]
        return on_j, apps, caps, self.n[on_j][None, :].astype(float), c_hint
