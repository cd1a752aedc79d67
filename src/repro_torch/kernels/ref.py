"""Plain-torch versions of the port's kernels.

``crms_grid_plain`` repeats the CUDA kernel's float32 arithmetic step for step
(same streaming logsumexp, Stirling log n!, sentinel and operation order); the
CPU path of ``ops.crms_grid`` runs it and the tests hold the kernel to it.
``crms_grid_terms``/``crms_grid_utility`` are the float64 oracle: Eq. (1) ->
μ -> exact Erlang-C Ws -> Eq. (8) utility.

``flash_attention_plain`` is the flash kernel's plain version (the same
tiles, masks, online softmax and finalisation, in float32);
``attention_naive`` is the O(S²)-memory oracle. ``flash_attention_bwd`` is
the gradient of attention, the reference's blockwise recompute
(``repro/kernels/ref.py::_flash_bwd``) with its log-sum-exp recomputed by
``flash_lse`` (the reference's ``_fwd_streaming``).

``tf32_rna`` and ``tf32_einsum`` repeat the kernels' TF32 rounding and
error-compensated TF32 products (the float32 flash and SSD kernels), for the
tests that emulate those kernels' arithmetic on the CPU.

``ssd_chunk_plain`` is the SSD chunk kernel's plain version (the body of the
reference's Pallas kernel per (batch, chunk, head), batched);
``ssd_chunks_reference`` is the einsum oracle, a copy of the reference's
``models/mamba.py::_ssd_chunks_ref``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import queueing
from repro_torch.core.perf_model import eq1_latency

F32 = torch.float32

MAX_N = 128  # container counts the kernel's k-sum covers (edge scenarios: N <= ~40)
HALF_LOG_2PI = 0.91893853320467274178  # 0.5 * log(2π), rounded to f32 on use
WS_UNSTABLE = 1e9  # ws sentinel for ρ >= 1


def _logaddexp(x, y):
    """max + log1p(exp(-|x - y|)), with x + y where the difference is NaN."""
    delta = x - y
    out = torch.maximum(x, y) + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(torch.isnan(delta), x + y, out)


def head_sum_steps(n) -> int:
    """The k-steps of the Erlang head sum that the counts ``n`` need:
    min(ceil(max n), MAX_N) - 1 over the counts that are not NaN (an
    infinite count needs MAX_N - 1, a NaN one none). A step k changes a
    lane only where n > k."""
    counts = n[~torch.isnan(n)]
    if counts.numel() == 0:
        return 0
    top = float(counts.max())
    if not top > 1:
        return 0
    return (MAX_N if top >= MAX_N else math.ceil(top)) - 1


def crms_grid_plain(kappa, lam, xbar, n, c, m, *, caps_cpu, power_span, alpha, beta,
                    reduce: str = "sum"):
    """float32 Eq. (8) utility of a (B, M) candidate grid: (B,) for
    ``reduce="sum"``, per-app terms (B, M) for ``reduce="per_app"``. Unstable
    lanes (ρ >= 1) carry ws = 1e9."""
    if reduce not in ("sum", "per_app"):
        raise ValueError(f"reduce must be 'sum' or 'per_app', got {reduce!r}")
    kappa = kappa.to(F32)
    k1, k2, k3 = kappa[:, 0], kappa[:, 1], kappa[:, 2]
    lam, xbar = lam.to(F32), xbar.to(F32)
    n, c, m = n.to(F32), c.to(F32), m.to(F32)

    # Divisions are tensor by tensor: torch evaluates `scalar / tensor` as a
    # reciprocal times the scalar, and on CUDA `tensor / scalar` as a product
    # with the scalar's reciprocal — each one rounding more than the kernel's
    # single division, which near rho -> 1 the Erlang tail amplifies ~1/(1-rho).
    d_ms = k1 / (1.0 - torch.exp(-k2 * c)) + torch.exp(k3 / m)
    mu = torch.full_like(d_ms, 1000.0) / (xbar * d_ms)
    a = lam / mu
    rho = lam / (n * mu)
    rho_s = torch.clamp(rho, max=1.0 - 1e-6)
    log_a = torch.log(a)

    # log Σ_{k=0}^{n-1} a^k/k! as a streaming logsumexp over k (running max,
    # rescaled running sum, log k!); the k=0 term is log 1 = 0. Steps with
    # k >= n leave both as they are, so the sum ends at the largest count
    # (head_sum_steps), as the kernel ends it at its warp's largest
    run_max = torch.zeros_like(a)
    run_sum = torch.ones_like(a)
    log_fact = torch.zeros((), dtype=F32, device=a.device)
    ks = torch.arange(1, head_sum_steps(n) + 1, dtype=F32, device=a.device)
    for kf in ks:
        log_fact = log_fact + torch.log(kf)
        term = kf * log_a - log_fact
        valid = n > kf
        new_max = torch.where(valid, torch.maximum(run_max, term), run_max)
        run_sum = run_sum * torch.exp(run_max - new_max) + torch.where(
            valid, torch.exp(term - new_max), 0.0
        )
        run_max = new_max
    log_head = run_max + torch.log(run_sum)

    # lgamma(n+1) via Stirling (n >= 1 here)
    nn = torch.clamp(n, min=1.0)
    log_nfact = (nn + 0.5) * torch.log(nn) - nn + HALF_LOG_2PI + 1.0 / (12.0 * nn)
    log_tail = n * log_a - log_nfact - torch.log1p(-rho_s)
    log_pi0 = -_logaddexp(log_head, log_tail)
    log_lq = n * log_a - log_nfact + torch.log(rho_s) - 2.0 * torch.log1p(-rho_s) + log_pi0
    ls = torch.exp(log_lq) + a
    ws = ls / lam
    ws = torch.where(rho < 1.0, ws, WS_UNSTABLE)

    dp = power_span * n * c / torch.full_like(c, caps_cpu)
    util = alpha * ws + beta * dp / lam
    return util if reduce == "per_app" else util.sum(dim=1)


def crms_grid_terms(kappa, lam, xbar, n, c, m, caps_cpu, power_span, alpha, beta):
    """Per-app utility terms (B, M) of Eq. (8) in float64. Unstable apps come
    back as +inf."""
    kappa, lam, xbar, n, c, m = (t.to(torch.float64) for t in (kappa, lam, xbar, n, c, m))
    d_ms = eq1_latency((kappa[:, 0], kappa[:, 1], kappa[:, 2]), c, m)
    mu = 1000.0 / (xbar * d_ms)
    ws = queueing.erlang_ws(n, lam.expand(n.shape), mu)
    dp = power_span * n * c / caps_cpu
    return alpha * ws + beta * dp / lam


def crms_grid_utility(kappa, lam, xbar, n, c, m, caps_cpu, power_span, alpha, beta):
    """Per-candidate float64 utility (B,): the row sum of ``crms_grid_terms``."""
    return torch.sum(
        crms_grid_terms(kappa, lam, xbar, n, c, m, caps_cpu, power_span, alpha, beta),
        dim=-1,
    )


# ----------------------------------------------------------------------------
# TF32 products of the flash (float32) and SSD kernels
# ----------------------------------------------------------------------------
def tf32_rna(a):
    """The kernels' rounding of a float32 operand to TF32 (the value of
    cvt.rna.tf32.f32): the magnitude rounded to 10 mantissa bits, ties away
    from zero, on the float32 bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_einsum(eq, a, b, terms: int = 3):
    """einsum ``eq`` of float32 operands as the kernels' products compute it
    on the tensor cores: in error-compensated TF32, each operand split as hi
    = tf32(x), lo = tf32(x - hi) and lo·hi + hi·lo + hi·hi summed in float32
    (``terms=3``), or hi·hi alone (``terms=1``)."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if terms == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


# ----------------------------------------------------------------------------
# flash attention — q (B, Sq, KV, G, hd), k/v (B, Skv, KV, hd)
# ----------------------------------------------------------------------------
def _flash_blocks(q, k, v, causal: bool, qb: int, kb: int, offset: int = 0):
    """Blockwise streaming softmax over kv tiles of ``kb`` keys, with q padded
    to a multiple of ``qb`` rows as the kernel tiles it. Returns the padded
    float32 output (B, KV, G, Sq_pad, hd); padded rows are fully masked and
    come out 0."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    scale = hd**-0.5
    sq_pad = -(-Sq // qb) * qb
    qf = torch.nn.functional.pad(q.to(F32), (0, 0, 0, 0, 0, 0, 0, sq_pad - Sq))
    kf, vf = k.to(F32), v.to(F32)
    dev = q.device
    q_pos = torch.arange(sq_pad, device=dev)[:, None]
    m = torch.full((B, KV, G, sq_pad), -torch.inf, dtype=F32, device=dev)
    l = torch.zeros((B, KV, G, sq_pad), dtype=F32, device=dev)
    acc = torch.zeros((B, KV, G, sq_pad, hd), dtype=F32, device=dev)
    for k_start in range(0, Skv, kb):
        kt, vt = kf[:, k_start:k_start + kb], vf[:, k_start:k_start + kb]
        s = torch.einsum("bqkgh,btkh->bkgqt", qf, kt) * scale
        k_pos = torch.arange(k_start, k_start + kt.shape[1], device=dev)[None, :]
        mask = (k_pos < Skv) & (q_pos < Sq)
        if causal:
            mask = mask & (q_pos + offset >= k_pos)
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkh->bkgqh", p, vt)
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def flash_attention_plain(q, k, v, causal: bool = True, qb: int = 32, kb: int = 32,
                          offset: int = 0):
    """Plain version of the flash kernel (its 32-row q tiles and 32-key kv
    tiles by default): masks ``k_pos < Skv``, ``q_pos < Sq`` and, if causal,
    ``q_pos + offset >= k_pos`` (top-left aligned, or with the query rows
    starting at row ``offset`` of the keys' sequence); ``acc / max(l,
    1e-30)``; float32 inside, q's dtype out, in q's (B, Sq, KV, G, hd)
    layout."""
    Sq = q.shape[1]
    out = _flash_blocks(q, k, v, causal, qb, kb, offset)[:, :, :, :Sq]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


DEFAULT_QB = 512  # the reference's query and key blocks of its blockwise backward
DEFAULT_KB = 1024


def _tile_scores(q_i, k_j, q0: int, k0: int, causal: bool, scale: float):
    """Scaled float32 scores (B, KV, G, qb, kb) of a (query block, key block)
    tile and its mask (top-left causal where ``causal``)."""
    s = torch.einsum("bqkgh,btkh->bkgqt", q_i, k_j) * scale
    q_pos = torch.arange(q0, q0 + q_i.shape[1], device=s.device)[:, None]
    k_pos = torch.arange(k0, k0 + k_j.shape[1], device=s.device)[None, :]
    mask = q_pos >= k_pos if causal else torch.ones_like(q_pos >= k_pos)
    return s, mask


def flash_lse(q, k, causal: bool = True, qb: int = DEFAULT_QB, kb: int = DEFAULT_KB,
              offset: int = 0):
    """float32 log-sum-exp of each query row's scaled, masked scores, (B, KV,
    G, Sq): the reference's ``_fwd_streaming`` (``m + log(max(l, 1e-30))``,
    m and l streamed over tiles of ``kb`` keys for blocks of ``qb`` rows)."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    scale = hd**-0.5
    qb, kb = min(qb, Sq), min(kb, Skv)
    qf, kf = q.to(F32), k.to(F32)
    lse = torch.empty((B, KV, G, Sq), dtype=F32, device=q.device)
    for q0 in range(0, Sq, qb):
        q_i = qf[:, q0:q0 + qb]
        m = torch.full((B, KV, G, q_i.shape[1]), -torch.inf, dtype=F32, device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Skv, kb):
            s, mask = _tile_scores(q_i, kf[:, k0:k0 + kb], q0 + offset, k0, causal, scale)
            s = torch.where(mask, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            m = m_new
        lse[..., q0:q0 + qb] = m + torch.log(torch.clamp(l, min=1e-30))
    return lse


def flash_attention_bwd(q, k, v, out, dout, causal: bool = True, qb: int = DEFAULT_QB,
                        kb: int = DEFAULT_KB, offset: int = 0):
    """Gradient of attention, the reference's ``_flash_bwd``: the log-sum-exp
    recomputed (``flash_lse``), ``D = rowsum(dout · out)``, and per (block of
    ``qb`` query rows, block of ``kb`` keys) tile ``p = exp(s - lse)`` on the
    mask (top-left causal where ``causal``), ``ds = p (dout vᵀ - D) ·
    scale``, dq += ds k, dv += pᵀ dout and dk += dsᵀ q, dk and dv summed over
    the G query heads of their kv head. The reference streams dq in one pass
    and dk/dv in a second over the same tiles; one loop recomputes each
    tile's p once and takes every sum in the reference's order (dq over key
    blocks, dk and dv over query blocks, each in ascending order). float32
    inside; q (B, Sq, KV, G, hd), k/v (B, Skv, KV, hd), out and dout in q's
    layout; returns dq, dk, dv in the inputs' dtypes."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    scale = hd**-0.5
    qb, kb = min(qb, Sq), min(kb, Skv)
    qf, kf, vf, dof = (t.to(F32) for t in (q, k, v, dout))
    lse = flash_lse(qf, kf, causal, qb, kb, offset)
    D = torch.einsum("bqkgh,bqkgh->bkgq", dof, out.to(F32))
    dq = torch.zeros_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, Sq, qb):
        q_i, do_i = qf[:, q0:q0 + qb], dof[:, q0:q0 + qb]
        lse_i, D_i = lse[..., q0:q0 + qb, None], D[..., q0:q0 + qb, None]
        for k0 in range(0, Skv, kb):
            k_j, v_j = kf[:, k0:k0 + kb], vf[:, k0:k0 + kb]
            s, mask = _tile_scores(q_i, k_j, q0 + offset, k0, causal, scale)
            p = torch.where(mask, torch.exp(torch.where(mask, s, -torch.inf) - lse_i), 0.0)
            dp = torch.einsum("bqkgh,btkh->bkgqt", do_i, v_j)
            ds = p * (dp - D_i) * scale
            dq[:, q0:q0 + qb] += torch.einsum("bkgqt,btkh->bqkgh", ds, k_j)
            dv[:, k0:k0 + kb] += torch.einsum("bkgqt,bqkgh->btkh", p, do_i)
            dk[:, k0:k0 + kb] += torch.einsum("bkgqt,bqkgh->btkh", ds, q_i)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_naive(q, k, v, causal: bool = True):
    """O(S^2)-memory oracle (tests only): materializes the score matrix."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqkgh,btkh->bkgqt", q.to(F32), k.to(F32)) * hd**-0.5
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Skv, device=q.device)
        s = torch.where(mask, s, -torch.inf)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,btkh->bqkgh", w, v.to(F32)).to(q.dtype)


# ----------------------------------------------------------------------------
# SSD chunk scan — x (B, S, H, P), bmat/cmat (B, S, N), da (B, S, H)
# ----------------------------------------------------------------------------
SCAN_BLOCK = 16  # block length of the reference's cumulative sums (below)


def cumsum_blocked(x, dim: int):
    """float32 cumulative sum of ``x`` along ``dim`` in the order the
    reference's ``jnp.cumsum`` takes on the CPU (XLA rewrites the cumulative
    reduce-window into blocks): sequential within blocks of 16 positions, the
    block totals scanned the same way (recursively) and added to every later
    block. The chunked SSD subtracts cumsums of ~200 in size, so the order of
    these sums is what the port and the reference differ by when it is not
    the same; with it they agree bit for bit. Any device, any length."""
    x = x.to(F32).movedim(dim, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out.movedim(-1, dim)
    nb = -(-n // SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * SCAN_BLOCK - n))
    local = cumsum_blocked(xp.reshape(*x.shape[:-1], nb, SCAN_BLOCK), -1)
    totals = cumsum_blocked(local[..., -1], -1)  # (..., nb), inclusive
    out = torch.cat([local[..., :1, :], local[..., 1:, :] + totals[..., :-1, None]], dim=-2)
    return out.reshape(*x.shape[:-1], nb * SCAN_BLOCK)[..., :n].movedim(-1, dim)


def ssd_chunk_plain(x, bmat, cmat, da, chunk: int):
    """Plain version of the SSD chunk kernel: per (batch, chunk, head) of
    ``chunk`` positions, ``cum = cumsum(da)`` (``cumsum_blocked``), ``L =
    where(i >= j, exp(cum_i - cum_j), 0)``, ``y_diag = (C Bᵀ ⊙ L) x`` and the
    chunk state ``xᵀ (B ⊙ exp(cum_end - cum))``. Needs S % chunk == 0.
    Returns y_diag (B, S, H, P), states (B, nc, H, P, N) and cum (B, S, H),
    float32."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q = chunk
    nc = S // Q
    xc = x.to(F32).reshape(B, nc, Q, H, P)
    bc = bmat.to(F32).reshape(B, nc, Q, N)
    cc = cmat.to(F32).reshape(B, nc, Q, N)
    cum = cumsum_blocked(da.reshape(B, nc, Q, H), dim=2)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q_i, Q_j, H)
    pos = torch.arange(Q, device=x.device)
    tri = (pos[:, None] >= pos[None, :])[:, :, None]
    # exp of -inf above the diagonal (not exp(seg) masked afterwards): the
    # same values, and a gradient of 0 there where exp(seg) may overflow
    L = torch.exp(torch.where(tri, seg, -torch.inf))
    scores = torch.einsum("bnis,bnjs->bnij", cc, bc)
    y = torch.einsum("bnijh,bnjhp->bnihp", scores[..., None] * L, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    bw = bc[:, :, :, None, :] * decay_to_end[..., None]  # (B, nc, Q, H, N)
    states = torch.einsum("bnthp,bnths->bnhps", xc, bw)
    return y.reshape(B, S, H, P), states, cum.reshape(B, S, H)


def ssd_chunks_reference(xh, bmat, cmat, da, chunk: int):
    """Chunked SSD scan, the reference's einsum oracle
    (``repro/models/mamba.py::_ssd_chunks_ref``, with its cumulative sums in
    the reference's order): xh (B, S, H, P), bmat/cmat (B, S, N), da (B, S, H)
    float32. Returns y (B, S, H, P) and the final state (B, H, P, N)."""
    Bb, S, H, Pd = xh.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xc = xh.reshape(Bb, nc, Q, H, Pd)
    bc = bmat.reshape(Bb, nc, Q, N)
    cc = cmat.reshape(Bb, nc, Q, N)
    dac = da.reshape(Bb, nc, Q, H)

    # intra-chunk (dual/attention form)
    cs = cumsum_blocked(dac.permute(0, 1, 3, 2), dim=-1)  # (B, nc, H, Q)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    L = torch.exp(torch.where(mask, seg, -torch.inf))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bnqs,bnts->bnqt", cc, bc)
    y_diag = torch.einsum("bnqt,bnhqt,bnthp->bnqhp", scores, L, xc)

    # chunk states: S_n = sum_t decay_to_end[t] * B[t] x[t]
    da_cum = cumsum_blocked(dac, dim=2)  # (B, nc, Q, H)
    decay_to_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)
    states = torch.einsum("bnts,bnth,bnthp->bnhps", bc, decay_to_end, xc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(da_cum[:, :, -1, :])  # (B, nc, H)
    s_prev = torch.zeros((Bb, H, Pd, N), dtype=F32, device=xh.device)
    s_in = []
    for n in range(nc):
        s_in.append(s_prev)
        s_prev = states[:, n] + chunk_decay[:, n, :, None, None] * s_prev
    s_in = torch.stack(s_in, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: y_off[t] = C[t] · decay_in[t] · S_in
    decay_in = torch.exp(da_cum)
    y_off = torch.einsum("bnts,bnth,bnhps->bnthp", cc, decay_in, s_in)
    return (y_diag + y_off).reshape(Bb, S, H, Pd), s_prev
