"""Plain float32 reference of the port's MoE decoder, as a configuration's
``program`` group of family ``moe`` states it: grouped-query attention, no
shared experts, no leading dense layer, and a softmax router whose top-k
weights are renormalised, with a capacity of ``moe_cf`` times the mean load
per expert. (No cell runs it yet: the port's architecture departs from the
published MoE models of its size, which have latent attention, shared
experts or sigmoid routers.)

A layer: RMSNorm (eps 1e-6), q/k/v (d x heads x hd), RoPE over whole heads
at positions 0..S-1, causal softmax attention, the output projection, the
residual; RMSNorm, the router's softmax over E experts, top-k (ties to the
lower index), the k weights renormalised, each (token, slot) placed in its
expert's buffer at its position in token-major order and dropped at or past
the capacity C = max(8, ceil8(ceil(T k cf / E))) with T the group's tokens,
the experts' SwiGLU products, the weighted sum, the residual. Then RMSNorm
and the head at the last position. Prompts are left-padded with token 0 and
attend to the pads, as the Engine's prefill does.

``prefill_last_logits`` runs a group in blocks (a batch row of attention at
a time, an expert at a time) and in float32 from the served weights; with
``routes`` it takes the program's expert ids instead of its own top-k (the
routing decision, which near-ties in bfloat16 move) and reports how far each
route lies from its own top-k; the capacity, the drops and the weights it
works out again.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.plain import F32, FP32, Precision, ceil_to, float32_products, rmsnorm, rope

NORM_EPS = 1e-6


def param_specs(prog: dict, weight_dtype: torch.dtype) -> list:
    """(name, shape, dtype, init) of every weight, named and shaped as the
    program's parameters; init is ("normal", std) or ("const", value)."""
    d, H, KV, V = prog["d_model"], prog["n_heads"], prog["kv_heads"], prog["vocab"]
    hd = prog.get("head_dim") or d // H
    moe = prog["moe"]
    E, f = moe["n_experts"], moe["d_ff_expert"]
    wd = weight_dtype
    specs = [("embed", (V, d), wd, ("normal", d**-0.5)),
             ("final_norm.w", (d,), wd, ("const", 1.0)),
             ("lm_head", (d, V), wd, ("normal", d**-0.5))]
    for i in range(prog["n_layers"]):
        a, m = f"layers.{i}.0", f"layers.{i}.1"
        specs += [
            (f"{a}.norm.w", (d,), wd, ("const", 1.0)),
            (f"{a}.attn.wq", (d, H, hd), wd, ("normal", d**-0.5)),
            (f"{a}.attn.wk", (d, KV, hd), wd, ("normal", d**-0.5)),
            (f"{a}.attn.wv", (d, KV, hd), wd, ("normal", d**-0.5)),
            (f"{a}.attn.wo", (H, hd, d), wd, ("normal", (H * hd)**-0.5)),
            (f"{m}.norm.w", (d,), wd, ("const", 1.0)),
            (f"{m}.moe.router", (d, E), F32, ("normal", d**-0.5)),
            (f"{m}.moe.w_gate", (E, d, f), wd, ("normal", d**-0.5)),
            (f"{m}.moe.w_up", (E, d, f), wd, ("normal", d**-0.5)),
            (f"{m}.moe.w_down", (E, f, d), wd, ("normal", f**-0.5)),
        ]
    return specs


def capacity(tokens: int, k: int, E: int, cf: float) -> int:
    return max(ceil_to(math.ceil(tokens * k * cf / E), 8), 8)


def top_k(probs, k: int):
    """The k largest along the last dim, ties to the lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _attention(x, w, prefix: str, prog: dict, prec: Precision, positions):
    B, S, d = x.shape
    H, KV = prog["n_heads"], prog["kv_heads"]
    hd = prog.get("head_dim") or d // H
    G = H // KV
    W = lambda n: w[f"{prefix}.attn.{n}"].to(F32)
    h = rmsnorm(x, w[f"{prefix}.norm.w"].to(F32), NORM_EPS)
    out = torch.empty((B, S, H * hd), dtype=F32, device=x.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    for b in range(B):
        hb = h[b]
        q = rope(prec.mm(hb, W("wq").reshape(d, H * hd)).reshape(S, H, hd), positions,
                 prog["rope_theta"])
        k = rope(prec.mm(hb, W("wk").reshape(d, KV * hd)).reshape(S, KV, hd), positions,
                 prog["rope_theta"])
        v = prec.mm(hb, W("wv").reshape(d, KV * hd)).reshape(S, KV, hd)
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        s = prec.mm(q.permute(1, 0, 2), k.permute(1, 2, 0)) * hd**-0.5  # (H, S, S)
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        out[b] = prec.mm(p, v.permute(1, 0, 2)).permute(1, 0, 2).reshape(S, H * hd)
        del q, k, v, s, p
    return x + prec.mm(out, W("wo").reshape(H * hd, d))


def _moe(x, w, prefix: str, prog: dict, prec: Precision, routes):
    """The MoE block; returns (x + its output, the widest route shortfall,
    the ids used)."""
    B, S, d = x.shape
    moe = prog["moe"]
    E, k = moe["n_experts"], moe["top_k"]
    T = B * S
    h = rmsnorm(x, w[f"{prefix}.norm.w"].to(F32), NORM_EPS).reshape(T, d)
    probs = torch.softmax(prec.mm(h, w[f"{prefix}.moe.router"].to(F32)), dim=-1)
    kth = top_k(probs, k)[0][:, -1]
    if routes is None or routes.numel() != T * k:
        # the reference's own top-k; routes that do not cover the group fail
        ids = top_k(probs, k)[1]
        shortfall = 0.0 if routes is None else math.inf
    else:
        ids = routes.reshape(T, k).to(probs.device).long()
        if (ids.sort(dim=-1).values.diff(dim=-1) == 0).any() or ids.min() < 0 or ids.max() >= E:
            shortfall = math.inf  # not k distinct experts
        else:
            shortfall = float((kth - torch.gather(probs, -1, ids).min(dim=-1).values).max())
    pk = torch.gather(probs, -1, ids)
    pk = pk / pk.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    C = capacity(T, k, E, prog.get("moe_cf", 1.25))
    flat = ids.reshape(-1)
    one_hot = F.one_hot(flat, E)
    pos = ((torch.cumsum(one_hot, dim=0) - one_hot) * one_hot).sum(dim=-1)
    keep = pos < C
    y = torch.zeros((T, d), dtype=F32, device=x.device)
    slot_tok = torch.arange(T * k, device=x.device) // k
    for e in range(E):
        sel = (flat == e) & keep
        toks = slot_tok[sel]
        if toks.numel() == 0:
            continue
        he = h[toks]
        g = prec.mm(he, w[f"{prefix}.moe.w_gate"][e].to(F32))
        u = prec.mm(he, w[f"{prefix}.moe.w_up"][e].to(F32))
        ye = prec.mm(F.silu(g) * u, w[f"{prefix}.moe.w_down"][e].to(F32))
        y.index_add_(0, toks, ye * pk.reshape(-1)[sel][:, None])
    return x + y.reshape(B, S, d), shortfall, ids.reshape(B, S, k)


def prefill_last_logits(w: dict, prog: dict, tokens, routes=None, prec: Precision = FP32):
    """The last position's logits (B, V) in float32 of a padded group
    ``tokens`` (B, S), with ``routes`` (a (B, S, k) id tensor per layer) or
    the reference's own top-k. Returns (logits, the widest route shortfall
    over the layers: the reference's k-th largest router probability less the
    smallest it gives a route taken, inf where a route is not k distinct
    experts; 0 with its own top-k, and the ids it used)."""
    if prog["family"] != "moe" or prog.get("moe_every", 1) != 1:
        raise ValueError("moe_decoder: an MoE block after every attention block only")
    with float32_products(), torch.no_grad():
        tokens = torch.as_tensor(tokens, device=w["embed"].device).long()
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        x = w["embed"][tokens].to(F32)
        worst, used = 0.0, []
        for i in range(prog["n_layers"]):
            x = _attention(x, w, f"layers.{i}.0", prog, prec, positions)
            x, short, ids = _moe(x, w, f"layers.{i}.1", prog, prec,
                                 None if routes is None else routes[i])
            worst = max(worst, short)
            used.append(ids)
        last = rmsnorm(x[:, -1], w["final_norm.w"].to(F32), NORM_EPS)
        return prec.mm(last, w["lm_head"].to(F32)), worst, used
