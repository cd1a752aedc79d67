"""Latency of one small gloo all-reduce among ranks that share one card, as
chip_smoke.py's mesh phases run them:

    python benchmarks_torch/gloo_latency.py [--ranks 4] [--calls 300] [--device cuda]

Each rank all-reduces a 1 KB float32 tensor ``--calls`` times after a tiny
kernel, through gloo's own CUDA path and through explicit host copies, and
times a lone synchronise likewise; prints the card's name and power limit
(nvidia-smi) and each rank's milliseconds per call.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def rank_latency(rank, world, calls, device):
    import torch
    import torch.distributed as dist

    cuda = device == "cuda"
    x = torch.randn(256, device=device)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    out = {}
    for name in ("device_path", "host_copy"):
        sync()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(calls):
            y = x * 1.0001
            if name == "device_path":
                dist.all_reduce(y)
            else:
                h = y.cpu()
                dist.all_reduce(h)
                y = h.to(device)
        sync()
        out[name] = (time.perf_counter() - t) / calls * 1e3
    t = time.perf_counter()
    for _ in range(calls):
        y = x * 1.0001
        sync()
    out["synchronise"] = (time.perf_counter() - t) / calls * 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--calls", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import spawn

    if args.device == "cuda":  # the card beside its numbers
        import subprocess

        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    recs = spawn(rank_latency, args.ranks, backend="gloo", device=args.device,
                 args=(args.calls, args.device), timeout=600)
    for rank, rec in enumerate(recs):
        print(f"rank {rank} ms per call: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    return recs


if __name__ == "__main__":
    main()
