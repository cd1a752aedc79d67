"""Training launcher of the port:

    python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu --steps 4

runs the Trainer loop (checkpoints and automatic restart) in float32 on the
CUDA device unless ``--device`` names another, as ``python -m
repro.launch.train`` does on the reference. With ``--production-mesh`` it
trains sharded over the production mesh (``launch.mesh.make_production_mesh``,
256 ranks, one process a rank started by ``torchrun``, whose environment this
launcher joins) in bf16 compute (``launch.specs.make_runtime``), as the
reference does; with fewer ranks the mesh raises its RuntimeError, and
nothing falls back to one device.
"""
import argparse
import os


def parse(argv=None):
    from repro_torch.train.loop import DEFAULT_CKPT_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--production-mesh", action="store_true")
    return ap.parse_args(argv)


def run(args, mesh=None):
    """Train as ``args`` say, on ``mesh`` (a ``DeviceMesh``) where given, else
    on one device; prints the log lines (rank 0 of a mesh) and returns
    (history, restarts)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import make_runtime
    from repro_torch.models.layers import Runtime
    from repro_torch.train.loop import Trainer, TrainerConfig, run_with_recovery

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if mesh is not None:
        runtime = make_runtime(cfg, mesh, compute_dtype=torch.bfloat16)
    else:
        runtime = Runtime(device=args.device, compute_dtype=torch.float32)
    tcfg = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.global_batch, steps=args.steps,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, lr=args.lr,
    )
    history, restarts = run_with_recovery(
        lambda: Trainer(cfg, tcfg, runtime), total_steps=args.steps
    )
    if mesh is None or dist.get_rank() == 0:
        for h in history:
            print(f"step {h['step']:5d} loss {h['loss']:.4f} gnorm {h['grad_norm']:.3f} "
                  f"{h['dt'] * 1e3:.0f}ms")
        print(f"done: {len(history)} logs, {restarts} restarts")
    return history, restarts


def main(argv=None):
    args = parse(argv)
    mesh = None
    if args.production_mesh:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_production_mesh

        device_type = torch.device(args.device or "cuda").type
        if not dist.is_initialized() and "WORLD_SIZE" in os.environ:  # started by torchrun
            dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
            if device_type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        mesh = make_production_mesh(device_type=device_type)
    run(args, mesh)


if __name__ == "__main__":
    main()
