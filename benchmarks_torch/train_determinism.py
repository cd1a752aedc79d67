"""Is a mamba2-130m train step bit for bit repeatable on the card, and if not,
which operation first differs?

    python benchmarks_torch/train_determinism.py [--device cuda] [--out FILE]
        [--skip-mesh] [--reduced]

(``--device cpu --reduced`` rehearses it on the host at reduced sizes.)

Four checks, float32 compute, the seeded weights and batch of
``chip_smoke.py`` (mamba2-130m at full width and depth):

* ``mesh``: two uninterrupted Trainer runs of phase 23 (e)(ii)'s
  TrainerConfig (seq 512, batch 8, 4 steps) on four ranks sharing the card
  over gloo, pure data parallel, then the in-process restart with a failure
  at step 3: the largest parameter difference between the two uninterrupted
  runs, and between the restart and the first run.
* ``gloo_all_reduce_max_abs_diff``: seeded tensors of 1 Ki, 1 Mi and 129 Mi
  floats (the gradient's size) summed over the four ranks three times.
* ``mesh_ops``: one train step on the mesh run twice from the same weights
  under a dispatch mode that records a digest (the float64 sum and sum of
  squares) of each operation's floating-point outputs, forward and
  backward (allocations and views left out; a collective's input too): the
  first operation whose digest differs between the runs, the operations
  around it, and the names of the differing operations.
* ``ops``: the same digests of one step on one device (a rank's 2 x 512
  rows) run three times.

Prints one JSON object (and writes it to ``--out``).
"""
import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ROWS = 2  # a rank's rows of phase 23 (e)(ii)'s batch of 8 on four ranks


def mesh_rank(rank, world, root, device, reduced=False):
    """Two uninterrupted runs and the restart on this rank: (max |Δ| between
    the uninterrupted runs' parameters, max |Δ| restart against the first)."""
    import dataclasses

    import torch

    import chip_smoke as C
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.layers import whole
    from repro_torch.train.loop import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_smoke_mesh(2, 2, device_type=device)
    cfg = C.mesh_train_config(C.SSM_ARCH, reduced)
    rt = make_runtime(cfg, mesh, torch.float32)
    S, B = C.RESTART_MAMBA_REDUCED if reduced else C.RESTART_MAMBA
    tcfg = TrainerConfig(seq_len=S, global_batch=B, steps=4, ckpt_every=2,
                         ckpt_dir=str(Path(root) / "a"), seed=C.SEED, log_every=1)
    runs = []
    for sub in ("a", "b"):
        tr = Trainer(cfg, dataclasses.replace(tcfg, ckpt_dir=str(Path(root) / sub)), rt)
        tr.init_or_restore()
        tr.run()
        runs.append(tr)
    with torch.no_grad():
        twice = max(float((whole(a) - whole(b)).abs().max())
                    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()))
    restart = C.restart_case(cfg, rt, dataclasses.replace(tcfg, ckpt_dir=str(Path(root) / "r")),
                             3, ref=runs[0])
    return twice, restart["params_max_abs_err"]


def gloo_rank(rank, world, device, sizes):
    """Each size's seeded float32 tensor (its own on each rank) summed over
    the ranks by ``dist.all_reduce`` three times: the largest difference
    between the sums and the first, a size."""
    import torch
    import torch.distributed as dist

    out = {}
    for n in sizes:
        x = torch.randn(n, generator=torch.Generator().manual_seed(rank * 1000 + n)).to(device)
        sums = []
        for _ in range(3):
            y = x.clone()
            dist.all_reduce(y)
            sums.append(y)
        out[n] = max(float((y - sums[0]).abs().max()) for y in sums[1:])
    return out


def mesh_ops_rank(rank, world, device, reduced=False):
    """One float32 train step of mamba2-130m on the (2, 2) mesh, pure data
    parallel (the seeded weights, the phase's batch), twice from the same
    weights, each under ``Digests`` (the collectives waited for and their
    inputs digested too): ``compare_ops`` of the two, and the ops around
    the first difference."""
    import torch

    import chip_smoke as C
    from repro_torch import interop
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.specs import make_runtime
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_smoke_mesh(2, 2, device_type=device)
    cfg = C.mesh_train_config(C.SSM_ARCH, reduced)
    S, B = C.RESTART_MAMBA_REDUCED if reduced else C.RESTART_MAMBA
    batch = C.mesh_train_batch(cfg, B, S, device)
    logs = []
    for _ in range(2):
        lm = interop.place_params(C.full_model(cfg, device, torch.float32), cfg, mesh,
                                  pure_dp=True)
        opt = adamw()
        state = opt.init(dict(lm.named_parameters()))
        logs.append([])
        with digest_mode(logs[-1]):
            make_train_step(cfg, make_runtime(cfg, mesh, torch.float32), opt, 1)(lm, state, batch)
        del lm, state
    res = compare_ops(logs)[0]
    if res and "first_index" in res:
        i = res["first_index"]
        res["around_first"] = [name for name, _ in logs[0][max(0, i - 6):i + 2]]
    return res


def digest_mode(log):
    """A dispatch mode appending (operation, digest) to ``log`` for each
    operation's floating-point outputs (a ``DTensor``'s local shard): the
    float64 sum and sum of squares. Allocations (uninitialised memory) and
    views are left out; a collective's inputs are digested before it runs,
    and its outputs after it completed."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def digest(name, tree):
        for t in tree_leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
                d = t.detach().double()
                log.append((name, torch.stack([d.sum(), (d * d).sum()])))

    class Digests(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            collective = name.startswith("c10d")
            if collective:  # the tensor it reads: (output, input, ...) or (in place, ...)
                digest(name + " (in)", args[1:2] if "_base_" in name or "alltoall" in name
                       else args[:1])
            out = func(*args, **(kwargs or {}))
            if collective:
                for leaf in tree_leaves(out):
                    if hasattr(leaf, "wait"):
                        leaf.wait()
                digest(name, out)
                return out
            if "empty" in name or any(r.alias_info is not None and not r.alias_info.is_write
                                      for r in func._schema.returns):
                return out
            digest(name, out)
            return out

    return Digests()


def digests_of_step(device, log, reduced=False):
    """One train step of mamba2-130m (ROWS x 512, float32 compute) under a
    dispatch mode recording [(operation, digest tensor)] in ``log``;
    returns the gradients (the first moment of a fresh AdamW, 0.1 g)."""
    import torch

    import chip_smoke as C
    from repro_torch.models.layers import Runtime
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    cfg = C.mesh_train_config(C.SSM_ARCH, reduced)
    S, _ = C.RESTART_MAMBA_REDUCED if reduced else C.RESTART_MAMBA
    lm = C.full_model(cfg, device, torch.float32)
    batch = C.mesh_train_batch(cfg, ROWS, S, device)
    opt = adamw()
    state = opt.init(dict(lm.named_parameters()))
    step = make_train_step(cfg, Runtime(device, torch.float32, "auto"), opt, 1)
    with digest_mode(log):
        step(lm, state, batch)
    return {n: m.clone() for n, m in state["m"].items()}


def compare_ops(logs):
    """The first operation whose digest differs between run 0 and each later
    run: {"ops": n, "first_index", "first_op", "differing_ops" (distinct
    names, first 12)}; None where every digest agrees."""
    import torch

    out = []
    base = logs[0]
    for other in logs[1:]:
        if len(other) != len(base):
            out.append({"ops": [len(base), len(other)], "first_op": "op counts differ"})
            continue
        a = torch.stack([d.cpu() for _, d in base])
        b = torch.stack([d.cpu() for _, d in other])
        diff = (a != b).any(dim=1).nonzero().flatten().tolist()
        if not diff:
            out.append(None)
            continue
        names = []
        for i in diff:
            if base[i][0] not in names:
                names.append(base[i][0])
        out.append({"ops": len(base), "first_index": diff[0], "first_op": base[diff[0]][0],
                    "differing": len(diff), "differing_ops": names[:12]})
    return out


def grads_gap(grads):
    return {n: max(float((g[n] - grads[0][n]).abs().max()) for g in grads[1:])
            for n in grads[0] if any(not bool((g[n] == grads[0][n]).all()) for g in grads[1:])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-mesh", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="reduced sizes (a CPU rehearsal)")
    args = ap.parse_args(argv)
    import shutil
    import subprocess

    import torch

    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.launch.mesh import spawn

    result = {}
    if args.device == "cuda":
        result["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True, check=True).stdout.strip()
        for kernel in (flash_attention, ssd):
            kernel.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    if not args.skip_mesh:
        root = tempfile.mkdtemp(prefix="repro_determinism_")
        t = time.perf_counter()
        recs = spawn(mesh_rank, 4, backend="gloo", device=args.device,
                     args=(root, args.device, args.reduced), timeout=900)
        shutil.rmtree(root, ignore_errors=True)
        result["mesh"] = {"uninterrupted_twice_max_abs_diff": [r[0] for r in recs],
                          "restart_max_abs_diff": [r[1] for r in recs],
                          "s": time.perf_counter() - t}
        print(json.dumps({"mesh": result["mesh"]}), flush=True)
        recs = spawn(gloo_rank, 4, backend="gloo", device=args.device,
                     args=(args.device, (1 << 10, 1 << 16) if args.reduced
                           else (1 << 10, 1 << 20, 129 << 20)), timeout=600)
        result["gloo_all_reduce_max_abs_diff"] = recs
        recs = spawn(mesh_ops_rank, 4, backend="gloo", device=args.device,
                     args=(args.device, args.reduced), timeout=600)
        result["mesh_ops"] = recs
        print(json.dumps({k: result[k] for k in ("gloo_all_reduce_max_abs_diff", "mesh_ops")}),
              flush=True)
    logs, grads = [], []
    for _ in range(3):
        logs.append([])
        grads.append(digests_of_step(args.device, logs[-1], args.reduced))
    result["ops"] = {"runs": compare_ops(logs), "grad_max_abs_diff": grads_gap(grads)}
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)


if __name__ == "__main__":
    main()
