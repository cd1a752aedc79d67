"""``chip_smoke.py`` as a module, loaded once per process, for the port's
tests that share its checks and records: ``from torch_scripts import
chip_smoke``. Its ``load_script`` loads the examples and benchmarks."""
import importlib.util
import pathlib


def _load():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load()


# ----------------------------------------------------------------------------
# Rank programs of the mesh tests (tests/test_torch_mesh*.py): each runs on
# every rank of a launch.mesh.spawn group (CPU, gloo) and returns NumPy
# results to the test, which holds them to the single-device port and the
# reference. They import the port only.
# ----------------------------------------------------------------------------
def _mesh_model(arch, mesh, layout="2d", cfg=None):
    from repro_torch import interop
    from repro_torch.configs import get_config

    cfg = cfg or get_config(arch).reduced()
    lm = interop.params_from_jax(interop.numpy_params(cfg, 0), cfg, "cpu")
    interop.place_params(lm, cfg, mesh, pure_dp=cfg.pure_dp, model_only=layout == "model_only")
    return cfg, lm


def _local_kv(caches):
    """{(stage, block, leaf): this rank's shard} of the K/V caches, copied."""
    return {(si, bi, leaf): blk[leaf].to_local().clone()
            for si, st in caches.items() for bi, blk in (st or {}).items()
            for leaf in ("k", "v") if leaf in blk}


def mesh_model_cases(rank, world, toks, labels, dec_toks, serve_setup):
    """The model cases on a (2, 2) mesh (float32, interop.numpy_params(cfg, 0)
    weights, as the single-device tests): the reduced moonshot's lm_loss; the
    reduced gemma-2b's decode steps over the T-sharded cache, with each
    step's owner-shard check; the reduced gemma-2b, mamba2-130m and moonshot
    engines on the golden setup; the MoE block's a2a and replicated modes on
    (2, 2) and (1, 4) against the local mode with given ids; BRANCH_CASES
    through ``branch_run``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, make_smoke_mesh
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.layers import model_rank, whole
    from repro_torch.models.model import apply_decode, init_cache, lm_loss
    from repro_torch.serve.engine import Engine, Request

    from repro_torch.launch.mesh import make_production_mesh

    out = {"errors": []}
    for make in (lambda: make_smoke_mesh(2, 2), lambda: make_production_mesh()):
        try:  # the default device type is CUDA; 256 ranks are more than the group
            make()
            out["errors"].append(None)
        except RuntimeError as e:
            out["errors"].append(str(e))
    mesh = make_smoke_mesh(2, 2, device_type="cpu")
    with torch.no_grad():
        cfg, lm = _mesh_model("moonshot-v1-16b-a3b", mesh)
        rt = make_runtime(cfg, mesh, torch.float32)
        out["loss"] = float(lm_loss(lm, cfg, rt, toks, labels)[0])

        out["decode_model_only"] = _mesh_decode(mesh, dec_toks, "model_only")[0]
        out["redistribute"] = redistribute_all_pairs(mesh)
        cfg, lm = _mesh_model("gemma-2b", mesh)
        rt = make_runtime(cfg, mesh, torch.float32)
        B, steps = dec_toks.shape
        caches = init_cache(cfg, rt, B, 64, dtype=torch.float32)
        T_loc = caches["stage0"]["b0"]["k"].to_local().shape[3]
        logits, owner = [], []
        for t in range(steps):
            before = _local_kv(caches)
            lg, caches = apply_decode(lm, cfg, rt, dec_toks[:, t:t + 1], caches, t)
            logits.append(whole(lg)[:, 0].numpy())
            after = _local_kv(caches)
            li = t - model_rank(rt) * T_loc
            mine = 0 <= li < T_loc
            same_off = all(torch.equal(torch.cat([before[key][..., :max(li, 0), :],
                                                  before[key][..., li + 1:, :]], dim=-2),
                                       torch.cat([after[key][..., :max(li, 0), :],
                                                  after[key][..., li + 1:, :]], dim=-2))
                           if mine else torch.equal(before[key], after[key])
                           for key in before)
            wrote = all(not torch.equal(before[key][..., li, :], after[key][..., li, :])
                        for key in before) if mine else None
            owner.append((bool(mine), bool(same_off), wrote))
        out["decode"] = np.stack(logits, axis=1)
        out["owner"] = owner
        out["t_shard"] = (caches["stage0"]["b0"]["k"].shape[3], T_loc)

        out["engines"] = {}
        for arch in ("gemma-2b", "mamba2-130m", "moonshot-v1-16b-a3b"):
            cfg, lm = _mesh_model(arch, mesh)
            eng = Engine(cfg, lm, make_runtime(cfg, mesh, torch.float32),
                         slots=serve_setup["slots"], max_len=serve_setup["max_len"])
            for rid, prompt in enumerate(serve_setup["prompts"]):
                eng.submit(Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                                   max_new=serve_setup["max_new"]))
            out["engines"][arch] = [r.out for r in sorted(eng.run(), key=lambda r: r.rid)]

        cfg = get_config("moonshot-v1-16b-a3b").reduced()
        dropless = cfg.moe.n_experts / cfg.moe.top_k
        out["moe"] = {}
        for shape in ((2, 2), (1, 4)):
            m = make_mesh(shape, ("data", "model"), "cpu")
            blocks = chip_smoke.moe_blocks(cfg, "cpu", m)
            for name, (B, S) in (("a2a", (4, 8)), ("replicated", (2, 1))):
                mode, got, want, _, _ = chip_smoke.mesh_moe_case(cfg, blocks, "cpu", m, B, S,
                                                                 dropless)
                out["moe"][(shape, name)] = (mode, got.numpy(), want.numpy())

        out["branches"] = {}
        for name in BRANCH_CASES:
            cfg, B, S, steps = branch_config(name)
            _, lm = _mesh_model(None, mesh, cfg=cfg)
            out["branches"][name] = branch_run(cfg, lm, make_runtime(cfg, mesh, torch.float32),
                                               B, S, steps)
    return out


# The mesh branches the gemma-2b and moonshot cases do not take, each in a
# reduced config: name -> (arch, config overrides, B, S, decode steps).
BRANCH_CASES = {
    # the Mamba mixer on a model axis of 2 (its conv / SSM states split over
    # 'model', gathered and written back), the MoE, heads split on KV
    "jamba": ("jamba-1.5-large-398b", {}, 4, 8, 3),
    # cross-attention over the projected patches (their batch rows)
    "vlm": ("llama-3.2-vision-90b", {}, 4, 8, 3),
    # the encoder over the frames (their batch rows), cross-attention
    "audio": ("seamless-m4t-large-v2", {}, 4, 8, 3),
    # KV 1 does not split, G 4 does: each rank its G / 2 query heads a group
    "heads_on_g": ("gemma-2b", {"attn_shard": "auto"}, 4, 8, 3),
    # neither KV 1 nor G 3 splits and S 7 does not either: every rank whole
    "unsplit": ("gemma-2b", {"n_heads": 3}, 4, 7, 3),
    # sequence mode with the residual split over S (the config's default):
    # each rank's block is its query rows, the cache filled from the gathered
    # sequence
    "sequence": ("gemma-2b", {}, 4, 8, 3),
    # the same with the residual whole between blocks
    "sequence_whole": ("gemma-2b", {"seq_shard_activations": False}, 4, 8, 3),
    # no head split (KV 1, G 3) with the residual split over S: the encoder's
    # non-causal self-attention and the decoder's cross-attention by query
    # rows
    "audio_rows": ("seamless-m4t-large-v2", {"n_heads": 3, "kv_heads": 1}, 4, 8, 3),
}


def branch_config(name):
    """(reduced config, B, S, decode steps) of BRANCH_CASES[name]."""
    from repro_torch.configs import get_config

    arch, changes, B, S, steps = BRANCH_CASES[name]
    return get_config(arch).reduced(**changes), B, S, steps


def branch_run(cfg, lm, runtime, B, S, steps, seed=3):
    """Seeded tokens (and patches / frames) through ``apply_lm``, then a
    cache-filling prefill and ``steps`` teacher-forced decode steps: the
    forward's logits (B, S, V) and the prefill's last and the steps' logits
    (B, 1 + steps, V), whole, as NumPy. The same code on one device and on a
    mesh."""
    import numpy as np
    import torch

    from repro_torch.models.layers import whole
    from repro_torch.models.model import apply_decode, apply_lm, init_cache

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (B, steps)).astype(np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_vision)).astype(
            np.float32)
    if cfg.family == "audio":
        extra["frames"] = rng.standard_normal(
            (B, max(S // cfg.enc_frames_ratio, 4), cfg.d_model)).astype(np.float32)
    forward = whole(apply_lm(lm, cfg, runtime, toks, extra)[0]).numpy()
    caches = init_cache(cfg, runtime, B, S + steps, dtype=torch.float32)
    lg, caches = apply_decode(lm, cfg, runtime, toks, caches, 0, extra)
    steps_out = [whole(lg)[:, -1].numpy()]
    for t in range(steps):
        lg, caches = apply_decode(lm, cfg, runtime, dec[:, t:t + 1], caches, S + t, extra)
        steps_out.append(whole(lg)[:, 0].numpy())
    return forward, np.stack(steps_out, axis=1)


def _mesh_decode(mesh, dec_toks, layout):
    """The reduced gemma-2b's decode steps on ``mesh`` in ``layout``: the
    whole logits (B, steps, V) and the caches."""
    import numpy as np
    import torch

    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.layers import whole
    from repro_torch.models.model import apply_decode, init_cache

    cfg, lm = _mesh_model("gemma-2b", mesh, layout)
    rt = make_runtime(cfg, mesh, torch.float32)
    caches = init_cache(cfg, rt, dec_toks.shape[0], 64, dtype=torch.float32)
    logits = []
    for t in range(dec_toks.shape[1]):
        lg, caches = apply_decode(lm, cfg, rt, dec_toks[:, t:t + 1], caches, t)
        logits.append(whole(lg)[:, 0].numpy())
    return np.stack(logits, axis=1), caches


def redistribute_all_pairs(mesh):
    """``layers.redistribute`` between every pair of placements of a (4, 8,
    12) tensor on a 2-D mesh (no two mesh dims splitting one tensor dim):
    (pairs checked, the pairs whose local shard or whole value is wrong)."""
    import itertools

    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.layers import distribute, redistribute, whole

    full = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    opts = [Replicate(), Shard(0), Shard(1), Shard(2)]

    def ok(a, b):
        return not (a.is_shard() and b.is_shard() and a.dim == b.dim)

    n, bad = 0, []
    for a, b, c, d in itertools.product(opts, repeat=4):
        if ok(a, b) and ok(c, d):
            y = redistribute(distribute(full, mesh, (a, b)), (c, d))
            n += 1
            if not (torch.equal(y.to_local(), distribute(full, mesh, (c, d)).to_local())
                    and torch.equal(whole(y), full)):
                bad.append(str((a, b, c, d)))
    return n, bad


def mesh_fleet_cases(rank, world, rows_stack):
    """The fleet cases on a (4,) "nodes" mesh: ip_solve_rows on a row stack;
    tests/test_placement.py's plans through FleetPlanner(mesh=...); the
    chip_smoke phase-19 path at 12 x 8; crms_fleet over three epochs. Returns
    the arrays and records the test compares with the single-device ones."""
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("nodes",), "cpu")
    return fleet_records(mesh, rows_stack)


def fleet_records(mesh, rows_stack):
    """The fleet cases' results with ``mesh`` (None: one device)."""
    import numpy as np
    import torch

    from repro_torch import api
    from repro_torch.core import engine, placement
    from repro_torch.core.problem import ServerCaps

    cpu = {"device": "cpu"}
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=float))  # noqa: E731
    out = {}
    for name, s in rows_stack.items():
        packed = {k: t(v) for k, v in s["rows"].items()}
        packed["mask"] = t(s["mask"])
        res = engine.ip_solve_rows(t(s["x0"]), packed, t(s["n"]), *(t(c) for c in s["caps"]),
                                   s["span"], 1.4, 0.2, width=s["width"], mesh=mesh)
        out[("rows", name)] = [a.numpy() for a in res]

    def state(planner, plan):
        return {"assignment": plan.assignment.copy(), "n": plan.n.copy(),
                "utility": plan.utility, "node_utility": plan.node_utility.copy(),
                **{k: getattr(planner, k).copy() for k in ("sol_c", "sol_m", "sol_ws")},
                "diagnostics": {k: v for k, v in plan.diagnostics.items()
                                if k != "wall_clock_s"}}

    apps, caps = placement.make_fleet(8, 6, seed=11)
    planner = placement.FleetPlanner(apps, caps, alpha=1.4, beta=0.2, mesh=mesh, **cpu)
    out["uniform"] = state(planner, planner.plan())
    apps, caps = placement.make_fleet(8, 6, seed=3)
    planner = placement.FleetPlanner(apps, caps, alpha=1.4, beta=0.2, mesh=mesh, **cpu)
    planner.plan()
    out["incremental"] = state(planner, planner.replan(
        lam={planner.apps[0].name: float(planner.lam[0]) * 1.4}))
    apps, caps = placement.make_fleet(6, 6, seed=7)
    planner = placement.FleetPlanner(apps, caps, alpha=1.4, beta=0.2, mesh=mesh, **cpu)
    planner.plan()
    src = int(planner.assignment[0])
    out["migration"] = state(planner, planner.replan(
        migrations=[(planner.apps[0].name, (src + 3) % planner.N)]))
    sizes = (3, 8, 16)  # tests/test_placement.py's ragged nodes, one padded batch
    apps, _ = placement.make_fleet(3, 16, seed=5)
    planner = placement.FleetPlanner(
        list(apps)[:sum(sizes)], [(10.0 * n, 13.0 * n) for n in sizes], alpha=1.4, beta=0.2,
        exchange_rounds=0, initial_assignment=np.repeat(np.arange(3), sizes), mesh=mesh, **cpu)
    out["ragged"] = state(planner, planner.plan())
    _, cold, incr, _ = chip_smoke.run_fleet(placement, 12, 8, mesh=mesh, **cpu)
    out["phase19"] = (cold, incr)

    apps, caps = placement.make_fleet(5, 4, seed=4)
    pol = api.get_policy("crms_fleet")
    pol.reset()
    seq = []
    for step in range(3):
        drifted = tuple(a.with_lam(a.lam * (1.0 + 0.1 * step)) if i % 3 == 0 else a
                        for i, a in enumerate(apps))
        extra = {"node_caps": caps, "migrations": [("app00002", 4)] if step == 2 else [],
                 "mesh": mesh}
        res = api.allocate("crms_fleet", api.AllocRequest(
            apps=drifted, caps=ServerCaps(*caps[0]), alpha=1.4, beta=0.2, extra=extra, **cpu))
        a = res.allocation
        seq.append({"n": a.n, "r_cpu": a.r_cpu, "r_mem": a.r_mem, "ws": a.ws,
                    "utility": a.utility, "cold": res.diagnostics.extra["cold"],
                    "nodes_solved": res.diagnostics.nodes_solved})
    pol.reset()
    out["crms_fleet"] = seq
    return out


def mesh_gpu_smoke(rank, world):
    """tests/test_torch_gpu.py's two-rank smoke on the card: the fleet's plan
    at 16 x 8 on a (world,) "nodes" mesh against one rank's, and the MoE
    block at moonshot-v1-16b-a3b's width on a (1, world) mesh against its
    local mode (raises on a difference)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import placement
    from repro_torch.launch.mesh import make_mesh

    nodes = make_mesh((world,), ("nodes",), "cuda")
    plans = []
    for mesh in (None, nodes):
        planner, _, _, _ = chip_smoke.run_fleet(placement, 16, 8, device="cuda", mesh=mesh)
        plans.append(chip_smoke.fleet_rows(planner))
    rows_equal = all(np.allclose(plans[0][k], plans[1][k], rtol=1e-9, atol=0)
                     for k in plans[0])
    cfg = get_config("moonshot-v1-16b-a3b")
    mesh = make_mesh((1, world), ("data", "model"), "cuda")
    blocks = chip_smoke.moe_blocks(cfg, "cuda", mesh)
    dropless = cfg.moe.n_experts / cfg.moe.top_k
    modes = {}
    with torch.inference_mode():
        for name, (B, S) in (("a2a", (2, 128)), ("replicated", (1, 1))):
            mode, got, want, _, _ = chip_smoke.mesh_moe_case(cfg, blocks, "cuda", mesh, B, S,
                                                             dropless)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
            modes[name] = mode
    return {"rows_equal": bool(rows_equal), "moe": modes}


# ----------------------------------------------------------------------------
# Rank programs of the sharded train step's tests (tests/test_torch_mesh_train*.py)
# ----------------------------------------------------------------------------
# The per-leaf gradient cases, each a shard mode of the mesh: name -> (arch,
# config overrides, B, S).
GRAD_CASES = {
    # attention in sequence mode (each rank a block of query rows), the tied head
    "gemma": ("gemma-2b", {}, 4, 16),
    # heads split on KV, the q/k/v biases
    "codeqwen": ("codeqwen1.5-7b", {}, 4, 16),
    # the MoE in its a2a mode, on given ids
    "moonshot": ("moonshot-v1-16b-a3b", {}, 4, 16),
    # pure data parallel over ('data', 'model')
    "mamba": ("mamba2-130m", {}, 4, 16),
    # KV 1 does not split, G 4 does: each rank its G / 2 query heads a group
    "heads_on_g": ("gemma-2b", {"attn_shard": "auto"}, 4, 16),
    # neither KV 1 nor G 3 splits and S 7 does not either: every rank whole
    "unsplit": ("gemma-2b", {"n_heads": 3}, 4, 7),
}
# The cases above split the residual over S between the layers where the
# reference does (the configs' seq_shard_activations; not under pure data
# parallelism, nor where S does not split); each of those again with the
# residual whole between the layers
GRAD_CASES.update({f"{name}_whole": (arch, {**changes, "seq_shard_activations": False}, B, S)
                   for name, (arch, changes, B, S) in list(GRAD_CASES.items())
                   if name not in ("mamba", "unsplit")})


def residual_rows(cfg, S, model_n=2):
    """The rows of S a rank's residual holds between the layers on a model
    axis of ``model_n``: the reference's ``residual_constrain`` condition."""
    split = (cfg.seq_shard_activations and not cfg.pure_dp and S % model_n == 0
             and S >= model_n)
    return S // model_n if split else S


def grad_batch(cfg, B, S, seed=5):
    """Seeded tokens and labels (B, S) of a gradient case."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def adafactor_grads(lm, seed=7):
    """{parameter name: seeded float32 gradient} shaped as ``lm``'s
    parameters (NumPy)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(tuple(p.shape)).astype(np.float32)
            for name, p in lm.named_parameters()}


# GRAD_CASES whose gradients are also taken through the train step, two
# microbatches, with the moved weights held for the step and without
STEP_CASES = ("gemma", "codeqwen", "mamba", "heads_on_g", "unsplit")
# train.step.hold_budget in those steps: all held, none, and 64 KiB a rank,
# which holds the first blocks' weights but not all
HOLDS = {"all": float("inf"), "none": 0, "some": 65536}


def step_grads(cfg, lm, mesh, toks, labels, budget):
    """One float32 AdamW train step of ``lm`` on ``mesh`` over (toks, labels)
    in two microbatches, holding up to ``budget`` bytes of moved weights
    (``train.step.hold_budget`` replaced meanwhile): (its loss, the gradient
    the optimizer took, gathered whole in the reference's tree layout, and
    the collectives the step issued before the update)."""
    import torch

    from repro_torch import interop
    from repro_torch.launch.specs import make_runtime
    from repro_torch.train import step as S
    from repro_torch.train.optimizer import Optimizer, adamw

    base, seen = adamw(), {}
    with chip_smoke.c10d_calls() as calls:
        def update(grads, state, params):
            seen["calls"] = sum(n for n, _ in calls.values())
            seen["grads"] = interop.params_to_jax(lm, cfg, grads)
            return base.update(grads, state, params)

        opt = Optimizer(init=base.init, update=update, name="recording")
        step = S.make_train_step(cfg, make_runtime(cfg, mesh, torch.float32), opt, 2)
        hold_budget, S.hold_budget = S.hold_budget, lambda runtime: budget
        try:
            _, _, metrics = step(lm, opt.init(dict(lm.named_parameters())),
                                 {"tokens": toks, "labels": labels})
        finally:
            S.hold_budget = hold_budget
    return float(metrics["loss"]), seen["grads"], seen["calls"]


def mesh_train_cases(rank, world, routes):
    """On a (2, 2) mesh, float32, interop.numpy_params(cfg, 0) weights:
    GRAD_CASES' loss and its gradients (gathered whole, in the reference's
    tree layout), the MoE case on ``routes``; STEP_CASES' train steps
    (``step_grads``) with the weights held and without; the reference's
    test_train_step_runs_on_mesh (reduced codeqwen, two microbatches, the
    same batch twice); one Adafactor step of the reduced gemma-2b's
    parameters with adafactor_grads, the parameters after it (whole)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.layers import distribute
    from repro_torch.models.model import lm_loss
    from repro_torch.train.optimizer import adafactor, adamw
    from repro_torch.train.step import make_train_step

    mesh = make_smoke_mesh(2, 2, device_type="cpu")
    out = {"grads": {}, "step": {}, "residual_rows": {}}
    apply_layer = M._apply_layer
    for name, (arch, changes, B, S) in GRAD_CASES.items():
        cfg, lm = _mesh_model(None, mesh, cfg=get_config(arch).reduced(**changes))
        toks, labels = grad_batch(cfg, B, S)
        held = moe.replaying_routes([torch.as_tensor(r).long() for r in routes[name]]) \
            if name in routes else contextlib.nullcontext()
        rows = out["residual_rows"][name] = set()

        def recording_layer(layer, x, *args, **kwargs):  # the rows of each layer's input
            rows.add(x.shape[1])
            return apply_layer(layer, x, *args, **kwargs)

        M._apply_layer = recording_layer
        try:
            with held:
                loss, _ = lm_loss(lm, cfg, make_runtime(cfg, mesh, torch.float32), toks, labels)
                loss.backward()
        finally:
            M._apply_layer = apply_layer
        grads = interop.params_to_jax(lm, cfg, {n: p.grad for n, p in lm.named_parameters()})
        out["grads"][name] = (float(loss.detach()), grads)
        if name in STEP_CASES:
            out["step"][name] = {hold: step_grads(cfg, _mesh_model(None, mesh, cfg=cfg)[1], mesh,
                                                  toks, labels, budget)
                                 for hold, budget in HOLDS.items()}

    cfg, lm = _mesh_model("codeqwen1.5-7b", mesh)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (8, 32)).astype(np.int32)}
    opt = adamw(lr=1e-3)
    state = opt.init(dict(lm.named_parameters()))
    step = make_train_step(cfg, make_runtime(cfg, mesh, torch.float32), opt, 2)
    losses = []
    for _ in range(2):
        lm, state, metrics = step(lm, state, batch)
        losses.append(float(metrics["loss"]))
    out["runs_on_mesh"] = losses

    cfg, lm = _mesh_model("gemma-2b", mesh)
    params = dict(lm.named_parameters())
    grads = {n: distribute(torch.as_tensor(g), mesh, params[n].placements)
             for n, g in adafactor_grads(lm).items()}
    opt = adafactor(lr=1e-3)
    opt.update(grads, opt.init(params), params)
    out["adafactor"] = interop.params_to_jax(lm, cfg)
    out["placements"] = {n: str(p.placements) for n, p in params.items()}
    return out


def mesh_golden_cases(rank, world, golden):
    """chip_smoke's phase-23 part (a) on a (2, 2) CPU mesh: each golden
    entry's curve [(loss, grad_norm)] and the (flash, ssd) launches."""
    from repro_torch.launch.mesh import make_smoke_mesh

    out = {}
    chip_smoke.part_train_golden(out, {"refs": {"train_golden": golden}, "device": "cpu",
                                       "mesh": make_smoke_mesh(2, 2, device_type="cpu")})
    return out


def mesh_loop_cases(rank, world, ckpt_dir, one_device_ckpt):
    """The pod all-reduce, the Trainer, the checkpoints and the launcher on
    four ranks: compress_allreduce_pod on a 1-pod (1, 4) and a (2, 2)
    ("pod", "data") mesh (chip_smoke.run_compress); on the (2, 2) mesh the
    Trainer's in-process restart (chip_smoke.restart_case) and, with no
    restart allowed, its crash and the fresh trainers' resume, each against
    an uninterrupted run (the parameters whole); the mesh's parameters saved
    under ``ckpt_dir``, and
    ``one_device_ckpt`` (written on one device) restored onto the mesh
    (whole); launch.train's body on the (2, 2) mesh, and the production
    mesh's error in this group."""
    import os

    import torch

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh, make_smoke_mesh
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.layers import whole
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import Trainer, TrainerConfig, run_with_recovery

    out = {"compress_one_pod": chip_smoke.run_compress(make_mesh((1, 4), ("pod", "data"), "cpu"),
                                                       "cpu"),
           "compress_two_pods": chip_smoke.run_compress(
               make_mesh((2, 2), ("pod", "data"), "cpu"), "cpu")}
    mesh = make_smoke_mesh(2, 2, device_type="cpu")
    cfg = get_config("gemma-2b").reduced()
    rt = make_runtime(cfg, mesh, torch.float32)

    def tcfg(sub):
        return TrainerConfig(seq_len=16, global_batch=4, steps=12, ckpt_every=4,
                             ckpt_dir=os.path.join(ckpt_dir, sub), seed=0, log_every=1)

    ref = Trainer(cfg, tcfg("ref"), rt)
    ref.init_or_restore()
    ref.run()
    # the in-process restart on the mesh, against the uninterrupted run
    out["restart"] = chip_smoke.restart_case(cfg, rt, tcfg("restart"), 6, ref=ref)
    try:  # with no restart allowed the failure is raised on every rank
        run_with_recovery(lambda: Trainer(cfg, tcfg("rec"), rt), total_steps=12, fail_at=6,
                          max_restarts=0)
        error = None
    except RuntimeError as e:
        error = str(e)
    resumed_from = ckpt.latest_step(os.path.join(ckpt_dir, "rec"))
    # the relaunch: fresh trainers on every rank resume from LATEST
    _, restarts = run_with_recovery(lambda: Trainer(cfg, tcfg("rec"), rt), total_steps=12)
    rec = Trainer(cfg, tcfg("rec"), rt)
    step = rec.init_or_restore()
    out["recovery"] = (error, resumed_from, restarts, step,
                       interop.params_to_jax(ref.params, cfg),
                       interop.params_to_jax(rec.params, cfg))

    _, lm = _mesh_model(None, mesh, cfg=cfg)
    ckpt.save(os.path.join(ckpt_dir, "mesh"), 1, {"params": dict(lm.named_parameters())})
    _, tree = ckpt.restore(one_device_ckpt, {"params": dict(lm.named_parameters())})
    with torch.no_grad():
        out["restored"] = {n: whole(v).numpy() for n, v in tree["params"].items()}
    out["restored_placements"] = {n: str(v.placements) for n, v in tree["params"].items()}

    args = train.parse(["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "4",
                        "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "2",
                        "--ckpt-dir", os.path.join(ckpt_dir, "launch")])
    history, restarts = train.run(args, mesh)
    out["launch"] = ([h["loss"] for h in history], restarts)
    try:
        train.main(["--arch", "gemma-2b", "--production-mesh", "--device", "cpu"])
        out["production_error"] = None
    except RuntimeError as e:
        out["production_error"] = str(e)
    return out


# ----------------------------------------------------------------------------
# The dry-run's collectives against a real group (tests/test_torch_dryrun_cells.py)
# ----------------------------------------------------------------------------
DRYRUN_STEP = ("gemma-2b", 4, 32)  # reduced arch, B, S of the (2, 2) train step


def dryrun_step(cfg, mesh, device="cpu"):
    """The reduced train step of DRYRUN_STEP on ``mesh``: (step, its
    arguments (the LM placed by the sharding rules, AdamW's state, a batch of
    zero tokens), the LM), made under whatever tensor mode is active."""
    import torch

    from repro_torch import interop
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.model import LM
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    _, B, S = DRYRUN_STEP
    lm = LM(cfg, device, torch.float32)
    interop.place_params(lm, cfg, mesh, pure_dp=cfg.pure_dp)
    opt = adamw()
    batch = {name: torch.zeros((B, S), dtype=torch.int32, device=device)
             for name in ("tokens", "labels")}
    step = make_train_step(cfg, make_runtime(cfg, mesh, torch.float32), opt)
    return step, (lm, opt.init(dict(lm.named_parameters())), batch), lm


def dryrun_gloo_collectives(rank, world):
    """DRYRUN_STEP's step on a (2, 2) mesh of real gloo ranks: the c10d
    collectives this rank issued ({name: [calls, result bytes]}, the
    dry-run's ``recording_collectives``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import recording_collectives
    from repro_torch.launch.mesh import make_smoke_mesh

    cfg = get_config(DRYRUN_STEP[0]).reduced()
    step, args, _ = dryrun_step(cfg, make_smoke_mesh(2, 2, device_type="cpu"))
    with recording_collectives() as calls:
        step(*args)
    return calls
