"""Training launcher of the port:

    python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu --steps 4

runs the Trainer loop (checkpoints and automatic restart) in float32 on the
CUDA device unless ``--device`` names another, as ``python -m
repro.launch.train`` does on the reference. The reference's
``--production-mesh`` (training sharded over a device mesh) needs the
sharded train step, which the port does not have yet: its mesh serves
(``launch.mesh``, ``launch.specs``), and the sharded train step is the next
slice (ROADMAP).
"""
import argparse


def main(argv=None):
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
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh needs the sharded train step, not ported yet; the port's "
                 "mesh serves only (ROADMAP, Queue 1 item 6)")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.layers import Runtime
    from repro_torch.train.loop import Trainer, TrainerConfig, run_with_recovery

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    runtime = Runtime(device=args.device, compute_dtype=torch.float32)
    tcfg = TrainerConfig(
        seq_len=args.seq_len, global_batch=args.global_batch, steps=args.steps,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, lr=args.lr,
    )
    history, restarts = run_with_recovery(
        lambda: Trainer(cfg, tcfg, runtime), total_steps=args.steps
    )
    for h in history:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} gnorm {h['grad_norm']:.3f} "
              f"{h['dt'] * 1e3:.0f}ms")
    print(f"done: {len(history)} logs, {restarts} restarts")


if __name__ == "__main__":
    main()
