"""End-to-end training driver on the port, as ``examples/train_small_lm.py``
runs it on the reference: a gemma-family LM trained with checkpointing and
automatic failure recovery.

Quick demo (a ~6M model, 120 steps, loss curve + injected crash + resume):
    PYTHONPATH=src python examples_torch/train_small_lm.py [--device cpu]

The ~100M-parameter / 300-step configuration:
    PYTHONPATH=src python examples_torch/train_small_lm.py --full

Training runs on the CUDA device unless ``--device`` names another (a
RuntimeError without a card). ``main`` returns the printed values as a dict.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.models.layers import Runtime
from repro_torch.train.loop import Trainer, TrainerConfig, run_with_recovery


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    runtime = Runtime(device=args.device, compute_dtype=torch.float32)

    base = get_config("gemma-2b")
    if args.full:
        # ~100M-parameter same-family config
        cfg = dataclasses.replace(
            base.reduced(), n_layers=12, d_model=768, n_heads=12, kv_heads=4,
            head_dim=64, d_ff=2048, vocab=32768,
        )
        steps, seq, gb = args.steps or 300, 512, 16
    else:
        cfg = dataclasses.replace(base.reduced(), n_layers=4, d_model=256, d_ff=512, vocab=2048)
        steps, seq, gb = args.steps or 120, 64, 8

    n_params = cfg.total_params()
    print(f"model: {n_params/1e6:.1f}M params ({cfg.n_layers}L d={cfg.d_model})")

    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(seq_len=seq, global_batch=gb, steps=steps,
                             ckpt_every=max(steps // 4, 10), ckpt_dir=d, lr=1e-3,
                             log_every=max(steps // 12, 5))
        # inject a crash at 60% to demonstrate checkpoint/restart
        history, restarts = run_with_recovery(
            lambda: Trainer(cfg, tcfg, runtime), total_steps=steps, fail_at=int(steps * 0.6)
        )
        for h in history:
            print(f"  step {h['step']:4d}  loss {h['loss']:7.4f}  gnorm {h['grad_norm']:7.3f}  "
                  f"{h['dt']*1e3:6.0f} ms/step")
        print(f"\nrecovered from {restarts} injected failure(s); "
              f"final loss {history[-1]['loss']:.4f} (start {history[0]['loss']:.4f})")
        assert history[-1]["loss"] < history[0]["loss"], "loss must decrease"
    return {"params": n_params, "history": history, "restarts": restarts}


if __name__ == "__main__":
    main()
