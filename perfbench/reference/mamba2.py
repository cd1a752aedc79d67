"""Plain float32 reference of the Mamba2 language model that the
configuration runs (``configs/mamba2-130m.json``'s ``program`` group), for
prefill and for training.

A layer: RMSNorm (eps 1e-6); the input projection to [z, x, B, C, dt]
(one group of B and C shared by the heads); a depthwise causal convolution
of width d_conv over [x, B, C] from a zero state, with its bias, and SiLU;
dt = softplus(dt_raw + dt_bias), A = -exp(a_log), da = dt A, x scaled by dt
per head; the state-space scan y_t = Σ_{s<=t} (C_t · B_s) exp(Σ_{s<r<=t}
da_r) x_s, plus D x; the gate y · silu(z), RMS-normalised (eps 1e-6) and
weighted; the output projection; the residual. Then RMSNorm and the head,
tied to the embedding. Training's loss is the mean of logsumexp less the
gold logit over every position, in float32; AdamW as ``plain.adamw_step``.

The scan is computed in chunks of 64 positions (``ssd_chunked``: the dual
quadratic form within a chunk, with the decays' exponents differenced in
float64, and the states across chunks as a recurrence), not in the
program's chunks of 256 and not from its kernel; ``ssd_sequential`` is its
definition as a recurrence over positions, which the tests hold the chunked
form to. Training recomputes each layer in the backward
(``torch.utils.checkpoint``).

Departures from the published mamba2-130m (hf:state-spaces/mamba2-130m):
none in the layer; the norms' eps is the port's 1e-6 (the source's 1e-5),
and the residual is float32 here as there; the weights are random, with the
layer's own initialisation of A (uniform in [1, 16]) and dt (log-uniform in
[1e-3, 1e-1]).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.plain import F32, FP32, Precision, adamw_step, blocks, float32_products, rmsnorm

NORM_EPS = 1e-6
REF_CHUNK = 64  # positions of the reference's chunks (the program's are 256)


def dims(prog: dict) -> dict:
    m = prog["mamba"]
    d_in = m["expand"] * prog["d_model"]
    return dict(d=prog["d_model"], d_in=d_in, N=m["d_state"], K=m["d_conv"],
                H=d_in // m["head_dim"], P=m["head_dim"], V=prog["vocab"])


def param_specs(prog: dict, weight_dtype: torch.dtype) -> list:
    """(name, shape, dtype, init) of every weight, named and shaped as the
    program's parameters; init is ("normal", std), ("const", value),
    ("a_log",) or ("dt_bias",)."""
    if prog["family"] != "ssm" or not prog.get("tie_embeddings"):
        raise ValueError("mamba2: an attention-free model with a tied head only")
    z = dims(prog)
    d, d_in, N, K, H, V = z["d"], z["d_in"], z["N"], z["K"], z["H"], z["V"]
    wd = weight_dtype
    specs = [("embed", (V, d), wd, ("normal", d**-0.5)),
             ("final_norm.w", (d,), wd, ("const", 1.0))]
    for i in range(prog["n_layers"]):
        p = f"layers.{i}.0"
        specs += [
            (f"{p}.norm.w", (d,), wd, ("const", 1.0)),
            (f"{p}.mamba.w_in", (d, 2 * d_in + 2 * N + H), wd, ("normal", d**-0.5)),
            (f"{p}.mamba.conv_w", (K, d_in + 2 * N), wd, ("normal", 0.1)),
            (f"{p}.mamba.conv_b", (d_in + 2 * N,), wd, ("const", 0.0)),
            (f"{p}.mamba.a_log", (H,), F32, ("a_log",)),
            (f"{p}.mamba.d_skip", (H,), F32, ("const", 1.0)),
            (f"{p}.mamba.dt_bias", (H,), F32, ("dt_bias",)),
            (f"{p}.mamba.norm_w", (d_in,), wd, ("const", 1.0)),
            (f"{p}.mamba.w_out", (d_in, d), wd, ("normal", d_in**-0.5)),
        ]
    return specs


# ----------------------------------------------------------------------------
# The scan
# ----------------------------------------------------------------------------
def ssd_sequential(xh, bmat, cmat, da):
    """The recurrence h_t = exp(da_t) h_{t-1} + x_t ⊗ B_t, y_t = h_t C_t from a
    zero state. xh (B, S, H, P), bmat/cmat (B, S, N), da (B, S, H)."""
    Bsz, S, H, P = xh.shape
    h = torch.zeros((Bsz, H, P, bmat.shape[-1]), dtype=F32, device=xh.device)
    ys = []
    for t in range(S):
        h = torch.exp(da[:, t])[..., None, None] * h + xh[:, t, :, :, None] * bmat[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", h, cmat[:, t]))
    return torch.stack(ys, dim=1)


def ssd_chunked(xh, bmat, cmat, da, prec: Precision = FP32, chunk: int = REF_CHUNK):
    """The scan in chunks of ``chunk`` positions: within a chunk the dual
    form (C_t · B_s) exp(Σ_{s<r<=t} da_r) x_s, the decays' exponents
    differenced in float64; across chunks the state each chunk hands on, as a
    recurrence over chunks. A sequence that is not a whole multiple of the
    chunk is padded with zeros at its end, which no earlier position sees.
    Shapes as ``ssd_sequential``'s; returns (B, S, H, P)."""
    Bsz, S, H, P = xh.shape
    N = bmat.shape[-1]
    Q = chunk
    pad = -S % Q
    if pad:
        xh, bmat, cmat, da = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                              for t in (xh, bmat, cmat, da))
    nc = (S + pad) // Q
    x = xh.reshape(Bsz, nc, Q, H, P)
    b, c = bmat.reshape(Bsz, nc, Q, N), cmat.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(da.double().reshape(Bsz, nc, Q, H), dim=2)  # float64, within chunks
    cum_t = cum.transpose(2, 3)  # (B, nc, H, Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xh.device).tril()
    decay = torch.exp((cum_t[..., :, None] - cum_t[..., None, :]).masked_fill(~causal, -torch.inf))
    m = prec.mm(c, b.transpose(-1, -2))[:, :, None] * decay.to(F32)  # (B, nc, H, Q_t, Q_s)
    y = prec.mm(m, x.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)  # (B, nc, Q, H, P)
    # the state each chunk adds, and the decay across a whole chunk
    to_end = torch.exp(cum[:, :, -1:, :] - cum).to(F32)  # (B, nc, Q, H)
    added = prec.mm((x * to_end[..., None]).permute(0, 1, 3, 4, 2), b[:, :, None])  # (B,nc,H,P,N)
    across = torch.exp(cum[:, :, -1, :]).to(F32)  # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=xh.device)
    entering = []
    for n in range(nc):
        entering.append(h)
        h = across[:, n, :, None, None] * h + added[:, n]
    h_in = torch.stack(entering, dim=1)  # (B, nc, H, P, N): the state entering each chunk
    y_in = prec.mm(c[:, :, None], h_in.transpose(-1, -2))  # (B, nc, H, Q, P)
    y = y + y_in.permute(0, 1, 3, 2, 4) * torch.exp(cum).to(F32)[..., None]
    return y.reshape(Bsz, nc * Q, H, P)[:, :S]


# ----------------------------------------------------------------------------
# The model
# ----------------------------------------------------------------------------
def _mixer(x, w, p: str, prog: dict, prec: Precision, scan):
    z_ = dims(prog)
    d_in, N, K, H, P = z_["d_in"], z_["N"], z_["K"], z_["H"], z_["P"]
    Bsz, S, _ = x.shape
    W = lambda n: w[f"{p}.mamba.{n}"].to(F32)
    h = rmsnorm(x, w[f"{p}.norm.w"].to(F32), NORM_EPS)
    zxbcdt = prec.mm(h, W("w_in"))
    z, xin, bmat, cmat, dt_raw = torch.split(zxbcdt, [d_in, d_in, N, N, H], dim=-1)
    u = torch.cat([xin, bmat, cmat], dim=-1)
    up = F.pad(u, (0, 0, K - 1, 0))
    cw = W("conv_w")
    conv = sum(up[:, i:i + S] * cw[i] for i in range(K)) + W("conv_b")
    xin, bmat, cmat = torch.split(F.silu(conv), [d_in, N, N], dim=-1)
    dt = F.softplus(dt_raw + W("dt_bias"))
    da = dt * -torch.exp(W("a_log"))
    xh = xin.reshape(Bsz, S, H, P) * dt[..., None]
    y = scan(xh, bmat, cmat, da, prec) + W("d_skip")[:, None] * xin.reshape(Bsz, S, H, P)
    g = y.reshape(Bsz, S, d_in) * F.silu(z)
    g = rmsnorm(g, W("norm_w"), NORM_EPS)
    return x + prec.mm(g, W("w_out"))


def _trunk(w, prog: dict, tokens, prec: Precision, scan, remat: bool):
    x = w["embed"][tokens].to(F32)
    for i in range(prog["n_layers"]):
        p = f"layers.{i}.0"
        if remat:
            x = checkpoint(_mixer, x, w, p, prog, prec, scan, use_reentrant=False)
        else:
            x = _mixer(x, w, p, prog, prec, scan)
    return rmsnorm(x, w["final_norm.w"].to(F32), NORM_EPS)


def prefill_last_logits(w: dict, prog: dict, tokens, routes=None, prec: Precision = FP32,
                        scan=ssd_chunked):
    """The last position's logits (B, V) in float32 of a padded group
    ``tokens`` (B, S). Returns (logits, 0.0, None): this model routes
    nothing."""
    if routes is not None:
        raise ValueError("mamba2: no routes to follow")
    with float32_products(), torch.no_grad():
        tokens = torch.as_tensor(tokens, device=w["embed"].device).long()
        last = _trunk(w, prog, tokens, prec, scan, remat=False)[:, -1]
        return prec.mm(last, w["embed"].to(F32).T), 0.0, None


def _nll_sum(xb, emb, labels, prec: Precision):
    logits = prec.mm(xb, emb.T)
    return (torch.logsumexp(logits, dim=-1)
            - torch.gather(logits, -1, labels[..., None])[..., 0]).sum()


def loss(w: dict, prog: dict, tokens, labels, prec: Precision = FP32, head_rows: int = 2):
    """Mean next-token negative log-likelihood (float32), the head and the
    loss in blocks of ``head_rows`` batch rows, each recomputed in the
    backward."""
    x = _trunk(w, prog, tokens, prec, ssd_chunked, remat=torch.is_grad_enabled())
    emb = w["embed"].to(F32)
    total = 0.0
    for rs in blocks(x.shape[0], head_rows):
        total = total + checkpoint(_nll_sum, x[rs], emb, labels[rs], prec, use_reentrant=False)
    return total / labels.numel()


def train_steps(w0: dict, prog: dict, batches, opt: dict, aux_coeff: float = 0.0,
                prec: Precision = FP32) -> dict:
    """AdamW steps from float32 weights ``w0`` (left unchanged) over
    ``batches`` ((tokens, labels) pairs). Returns each step's loss, the norm
    of each leaf's first gradient, and the norm of each leaf's change after
    the last step. The model has no auxiliary loss, so ``aux_coeff`` adds
    nothing."""
    with float32_products():
        params = {n: t.detach().to(F32).clone() for n, t in w0.items()}
        state = {"m": {n: torch.zeros_like(t) for n, t in params.items()},
                 "v": {n: torch.zeros_like(t) for n, t in params.items()}}
        out = {"loss": [], "grad_norm_1": {}, "delta_norm": {}}
        for step, (tokens, labels) in enumerate(batches, start=1):
            leaves = {n: t.requires_grad_() for n, t in params.items()}
            dev = leaves["embed"].device
            tokens = torch.as_tensor(tokens, device=dev).long()
            labels = torch.as_tensor(labels, device=dev).long()
            value = loss(leaves, prog, tokens, labels, prec)
            grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()),
                                                         allow_unused=True)))
            grads = {n: torch.zeros_like(leaves[n]) if g is None else g for n, g in grads.items()}
            out["loss"].append(float(value.detach()))
            if step == 1:
                out["grad_norm_1"] = {n: float(g.norm()) for n, g in grads.items()}
            with torch.no_grad():
                params = {n: t.detach() for n, t in leaves.items()}
                adamw_step(params, grads, state, step, **opt)
            del grads, value
        out["delta_norm"] = {n: float((params[n] - w0[n].to(F32)).norm()) for n in params}
    return out
