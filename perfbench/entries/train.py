"""Training through the program's step (``repro_torch.train.step.
make_train_step``) with its AdamW (``repro_torch.train.optimizer.adamw``),
on batches of the mix's stream, prefetched as the program's Trainer does.

Set-up builds the one model and optimizer state that the window trains, and
drives them through the window's own call and feed for the mix's
``checked_steps`` first steps (distinct rows each), reading on the way each
step's loss, each leaf's first gradient as the optimizer holds it (its first
moment after one step, over 1 - b1) and each leaf's change after the last
of them. The check runs the plain reference through the same steps from the
same weights and batches and compares, leaf by leaf at the worst leaf, the
gaps of the norms (``check``); ``control`` gives them for the reference in
float8.
"""
from __future__ import annotations

import statistics
import sys
import time

import torch

import program
import traffic
import weights as W
from reference.plain import Precision

RANGES = {
    "train.step": {"target": "entry:run_step"},
    "models.loss": {"target": "repro_torch.models.model:_vocab_parallel_nll"},
    "models.mamba": {"target": "repro_torch.models.mamba:apply_mamba"},
}


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def optimizer_update(opt, grads, state, params):
    """The program's optimizer update; a name the traced run can put a span
    around."""
    return opt.update(grads, state, params)


def setup(ctx):
    from repro_torch.train import optimizer as optim
    from repro_torch.train import step as train_step

    tcfg = ctx.cell.config["train"]
    prog = dict(ctx.prog, remat_policy=tcfg["remat_policy"],
                microbatches=ctx.cell.mix["microbatches"])
    dtype = program.DTYPES[tcfg["param_dtype"]]
    specs = ctx.reference.param_specs(prog, dtype)
    ctx.mark("program imported")
    w = W.make(specs, ctx.seed, ctx.device)
    w0 = {n: t.clone() for n, t in w.items()}
    _sync(ctx.device)
    ctx.mark("weights made")
    mcfg = program.model_config(prog)
    lm = program.model(mcfg, w, dtype, requires_grad=True)
    rt = program.runtime(ctx.device, tcfg["compute_dtype"], tcfg["attn_backend"])
    opt_cfg = tcfg["optimizer"]
    base = optim.adamw(**opt_cfg)
    opt = optim.Optimizer(init=base.init, name=base.name,
                          update=lambda g, s, p: optimizer_update(base, g, s, p))
    params = dict(lm.named_parameters())
    state = {"lm": lm, "opt_state": opt.init(params), "specs": specs, "prog": prog,
             "step_fn": train_step.make_train_step(mcfg, rt, opt),
             "feed": traffic.Prefetcher(traffic.train_source(ctx.cell.mix, ctx.seed,
                                                             prog["vocab"]),
                                        depth=ctx.cell.mix["prefetch_depth"])}
    losses = []
    for i in range(ctx.cell.mix["checked_steps"]):
        losses.append(float(run_step(ctx, state)[1]))
        if i == 0:
            m = state["opt_state"]["m"]
            state["grad_norm_1"] = {n: float(m[n].norm()) / (1 - opt_cfg["b1"]) for n in m}
    state["loss"] = losses
    state["delta_norm"] = {n: float((p.detach() - w0[n]).norm()) for n, p in params.items()}
    del w0
    return state


def run_step(ctx, state):
    """One step on the feed's next batch: (its step number, the loss)."""
    step, batch = state["feed"].next(timeout=120)
    batch = {k: torch.as_tensor(v, device=ctx.device) for k, v in batch.items()}
    _, state["opt_state"], metrics = state["step_fn"](state["lm"], state["opt_state"], batch)
    return step, metrics["loss"].item()


def window(ctx, state, seconds: float) -> dict:
    """Steps started until ``seconds`` have passed. ``steps`` holds each step
    finished inside the window; ``in_flight`` the tokens of the step that the
    window's close found running, times the share of that step's time that
    lay inside the window."""
    done, attempted, failed, in_flight = [], 0, 0, 0.0
    tokens = ctx.cell.mix["batch"] * ctx.cell.mix["seq_len"]
    _sync(ctx.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t_s = time.perf_counter()
        _, loss = run_step(ctx, state)
        t_e = time.perf_counter()
        attempted += 1
        if not loss == loss or loss in (float("inf"), float("-inf")):
            failed += 1
        elif t_e - t0 <= seconds:
            done.append((t_e - t_s, tokens))
        else:
            in_flight = tokens * (t0 + seconds - t_s) / (t_e - t_s)
    return {"t0": t0, "t_end": time.perf_counter(), "seconds": seconds, "steps": done,
            "in_flight": in_flight, "all_steps": attempted - failed, "attempted": attempted,
            "failed": failed}


def release(ctx, state):
    state["feed"].close()
    for k in ("lm", "opt_state", "step_fn"):
        state.pop(k, None)
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()


def _gaps(ctx, state, ref: dict) -> dict:
    """The worst leaf's gap of each compared norm."""
    lr = ref["loss"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(state["loss"], lr))
    g_ref, d_ref = ref["grad_norm_1"], ref["delta_norm"]
    g_med, d_med = statistics.median(g_ref.values()), statistics.median(d_ref.values())
    grad_gap = max(abs(state["grad_norm_1"][n] - g) / max(g, g_med) for n, g in g_ref.items())
    moving = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    gaps = {n: abs(state["grad_norm_1"][n] - g) / max(g, g_med) for n, g in g_ref.items()}
    deltas = {n: abs(state["delta_norm"][n] - d_ref[n]) / max(d_ref[n], d_med) for n in moving}
    worst_g, worst_d = max(gaps, key=gaps.get), max(deltas, key=deltas.get)
    print(f"perfbench: train check: worst gradient leaf {worst_g}, worst change leaf {worst_d}, "
          f"leaves left out of the change {sorted(set(g_ref) - set(moving))}", file=sys.stderr)
    return {"loss_gap": loss_gap, "grad_gap": gaps[worst_g], "delta_gap": deltas[worst_d]}


def _reference(ctx, state, prec: Precision) -> dict:
    w0 = W.make(state["specs"], ctx.seed, ctx.device)
    source = traffic.train_source(ctx.cell.mix, ctx.seed, state["prog"]["vocab"])
    batches = [(b["tokens"], b["labels"]) for b in
               (source.batch(i) for i in range(ctx.cell.mix["checked_steps"]))]
    return ctx.reference.train_steps(w0, state["prog"], batches,
                                     ctx.cell.config["train"]["optimizer"], prec=prec)


def check(ctx, state) -> dict:
    state["ref"] = _reference(ctx, state, Precision("fp32"))
    return _gaps(ctx, state, state["ref"])


def control(ctx, state) -> dict:
    """The gaps of the reference computed with float8 products, put in the
    program's place, judged by the float32 reference (the check's)."""
    ref = state.get("ref") or _reference(ctx, state, Precision("fp32"))
    low = _reference(ctx, state, Precision("fp8"))
    return _gaps(ctx, dict(state, loss=low["loss"], grad_norm_1=low["grad_norm_1"],
                           delta_norm=low["delta_norm"]), ref)
