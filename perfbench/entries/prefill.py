"""Prefill of a closed backlog through the program's serving step
(``repro_torch.serve.step.make_prefill_step``, the Engine's prefill): each
group of the mix (``traffic.Backlog``) is dispatched as the previous one's
first tokens reach the host, and a request's first token is the argmax of
its last position's logits.

The check (``check``): a sample of the groups that finished inside the
window, drawn from the seed with the first of the mix's longest groups in
it, is run again through the plain reference from the same weights and
padded tokens; each served token is judged by how far its reference logit
lies below the reference's best (``served_gap``), and each served row's
logits by their largest error over the reference logits' spread in the row
(``logit_gap``). For a model with experts the reference takes the program's
recorded routes, and judges them by how far each lies below the reference's
own top-k (``route_shortfall``). A cell's ``checks`` file names the numbers
it compares. ``control`` gives the same numbers for the reference in float8
put in the program's place.
"""
from __future__ import annotations

import time

import numpy as np
import torch

import program
import traffic
import weights as W
from reference.plain import Precision

RANGES = {
    "prefill.group": {"target": "entry:run_group"},
    "models.head": {"target": "repro_torch.models.model:_head"},
    "models.attention": {"target": "repro_torch.models.layers:apply_attention"},
    "models.mamba": {"target": "repro_torch.models.mamba:apply_mamba"},
}


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def setup(ctx):
    from repro_torch.serve import step as serve_step

    cfg = ctx.cell.config
    serve = cfg["serve"]
    prog = ctx.prog
    dtype = program.DTYPES[serve["weight_dtype"]]
    ctx.mark("program imported")
    w = W.make(ctx.reference.param_specs(prog, dtype), ctx.seed, ctx.device)
    _sync(ctx.device)
    ctx.mark("weights made")
    mcfg = program.model_config(prog)
    lm = program.model(mcfg, w, dtype, requires_grad=False)
    rt = program.runtime(ctx.device, serve["compute_dtype"], serve["attn_backend"])
    multiple = serve.get("pad_multiple", 1)
    state = {"w": w, "lm": lm, "step": serve_step.make_prefill_step(mcfg, rt),
             "backlog": traffic.Backlog(ctx.cell.mix, ctx.seed, prog["vocab"], multiple),
             "moe": prog.get("moe") is not None}
    # warm every group shape of the mix once, largest first
    rng = np.random.default_rng([ctx.seed, 2])
    for shape in traffic.group_shapes(ctx.cell.mix, multiple) if ctx.warm else ():
        toks = torch.as_tensor(rng.integers(0, prog["vocab"], shape), device=ctx.device)
        torch.argmax(state["step"](lm, {"tokens": toks}), dim=-1).cpu()
    state["checked"] = _checked(ctx, state["backlog"])
    return state


def _checked(ctx, backlog) -> callable:
    """The groups the check samples: every ``stride``-th from an offset drawn
    from the seed, and the first group of the mix's longest shape."""
    stride = ctx.cell.checks["check"]["stride"]
    offset = int(np.random.default_rng([ctx.seed, 3]).integers(stride))
    longest = traffic.group_shapes(ctx.cell.mix, backlog.pad_multiple)[0]
    first_longest = next(g for g in range(backlog.groups_per_cycle)
                         if backlog.group(g).shape == longest)
    return lambda g: g % stride == offset or g == first_longest


def run_group(state, tokens, check: bool):
    """One group through the program: its served tokens (numpy), and for a
    group the check samples its last positions' logits and its recorded
    routes (int8 on the device, a tensor a layer; None without experts)."""
    from repro_torch.models import moe

    if not check:
        last = state["step"](state["lm"], {"tokens": tokens})
        return torch.argmax(last, dim=-1).cpu().numpy(), None, None
    if state["moe"]:
        with moe.recording_routes() as ids:
            last = state["step"](state["lm"], {"tokens": tokens})
    else:
        last, ids = state["step"](state["lm"], {"tokens": tokens}), None
    served = torch.argmax(last, dim=-1).cpu().numpy()
    # a copy: ``last`` is a view of the whole (B, S, V) logits, which it would keep
    return served, last.clone(), None if ids is None else [i.to(torch.int8) for i in ids]


def window(ctx, state, seconds: float) -> dict:
    """Groups dispatched until ``seconds`` have passed. ``done`` holds each
    request finished inside the window; ``in_flight`` the real tokens of the
    group that the window's close found running, times the share of that
    group's time that lay inside the window."""
    backlog, checked = state["backlog"], state["checked"]
    done, kept, all_done = [], [], []
    attempted, in_flight = 0, 0.0
    _sync(ctx.device)
    t0 = time.perf_counter()
    g = 0
    while time.perf_counter() - t0 < seconds:
        group = backlog.group(g)
        check = checked(g)
        t_disp = time.perf_counter()
        tokens = torch.as_tensor(group.tokens, device=ctx.device)
        served, last, routes = run_group(state, tokens, check)
        t_done = time.perf_counter()
        attempted += len(group.rids)
        all_done += group.lengths
        if t_done - t0 <= seconds:
            done += [(t_done - t_disp, n) for n in group.lengths]
            if check:
                kept.append((group, served, last, routes))
        else:
            in_flight = group.real_tokens * (t0 + seconds - t_disp) / (t_done - t_disp)
        g += 1
    return {"t0": t0, "t_end": time.perf_counter(), "seconds": seconds, "done": done,
            "in_flight": in_flight, "kept": kept, "all_done": all_done,
            "attempted": attempted, "failed": 0}


def release(ctx, state):
    state.pop("lm", None)
    state.pop("step", None)
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()


def _judge(ctx, state, tokens, served, last, routes):
    """(served_gap, route_shortfall, logit_gap) of one group: how far each
    served token's reference logit lies below the reference's best; how far
    a route lies below the reference's own top-k; and the largest error of
    a served row's logits, over the reference logits' spread in that row."""
    logits, shortfall, _ = ctx.reference.prefill_last_logits(state["w"], ctx.prog, tokens,
                                                             routes=routes)
    best = logits.max(dim=-1).values
    got = logits.gather(-1, torch.as_tensor(served, device=logits.device).long()[:, None])[:, 0]
    err = (last.float() - logits).abs().max(dim=-1).values / logits.std(dim=-1)
    return float((best - got).max()), shortfall, float(err.max())


def _numbers(rows, moe: bool) -> dict:
    if not rows:
        return {}
    out = {"served_gap": max(r[0] for r in rows), "logit_gap": max(r[2] for r in rows)}
    if moe:
        out["route_shortfall"] = max(r[1] for r in rows)
    return out


def check(ctx, state) -> dict:
    rows = [_judge(ctx, state, group.tokens, served, last, routes)
            for group, served, last, routes in ctx.record["kept"]]
    return _numbers(rows, state["moe"])


def control(ctx, state) -> dict:
    """The same numbers for the reference computed with float8 products, its
    own routes, logits and argmax put in the program's place, on the groups
    the check sampled."""
    fp8 = Precision("fp8")
    rows = []
    for group, _, _, _ in ctx.record["kept"]:
        logits, _, ids = ctx.reference.prefill_last_logits(state["w"], ctx.prog, group.tokens,
                                                           prec=fp8)
        served = torch.argmax(logits, dim=-1).cpu().numpy()
        rows.append(_judge(ctx, state, group.tokens, served, logits,
                           ids if state["moe"] else None))
    return _numbers(rows, state["moe"])
