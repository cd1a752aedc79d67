"""Where the time of serving gemma-2b and mamba2-130m goes on the GPU.

    PYTHONPATH=src python benchmarks_torch/profile_serve.py [--out FILE]

For gemma-2b and mamba2-130m (``chip_smoke.py``'s ``FULL_ARCH`` and
``SSM_ARCH``) at full width and depth (random bf16 weights from a seeded
generator, bf16 compute, ``attn_backend="auto"``) on the CUDA device, at the
serving shape that ``chip_smoke.py`` checks (its ``SLOTS``, ``PROMPT_LEN`` and
``MAX_LEN``), after one warm-up of each: a torch.profiler trace of one
prefill of SLOTS x PROMPT_LEN tokens (``make_prefill_step``, the Engine's
prefill) and one of a decode step over a MAX_LEN-token cache
(``make_decode_step``). For each: host wall time
(closed by torch.cuda.synchronize()), device busy time (sum of kernel
times), the device's idle share of the wall, kernel launches, the model's
hand-written kernel's launches, device time and share (flash attention for
gemma-2b, the SSD chunk kernel for mamba2-130m), and the kernels with the
most device time.

Prints one JSON object, with nvidia-smi's "name, power.limit" (and writes it
to ``--out`` when given). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import FULL_ARCH, MAX_LEN, PROMPT_LEN, SEED, SLOTS, SSM_ARCH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, ssd  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.models.model import init_cache, init_params  # noqa: E402
from repro_torch.serve.step import make_decode_step, make_prefill_step  # noqa: E402

TOP = 10  # kernels listed by device time
# each model's hand-written kernel: its host module and a part of its CUDA
# functions' names ("flash_fwd": flash_fwd_wgmma in bf16, flash_fwd_tf32 in f32)
KERNELS = {FULL_ARCH: (flash_attention, "flash_fwd"),
           SSM_ARCH: (ssd, "ssd_chunk_kernel")}


def device_profile(fn, kernel, kernel_name):
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    launches0 = kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    kernel_ms = sum(v[0] for k, v in by_name.items() if kernel_name in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall), "device_kernels": len(kernels),
        "kernel_launches": kernel.launches - launches0, "kernel_device_ms": kernel_ms,
        "kernel_share_of_busy": kernel_ms / busy_ms if busy_ms else 0.0,
        "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in ranked[:TOP]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serve: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "slots": SLOTS,
           "prompt": PROMPT_LEN, "max_len": MAX_LEN, "models": {}}
    rt = Runtime("cuda", torch.bfloat16, "auto")
    for arch, (kernel, kernel_name) in KERNELS.items():
        cfg = get_config(arch)
        lm = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         torch.bfloat16, "cuda")
        tokens = torch.as_tensor(
            np.random.default_rng(SEED).integers(0, cfg.vocab, (SLOTS, PROMPT_LEN)),
            device="cuda")
        prefill = make_prefill_step(cfg, rt)
        decode = make_decode_step(cfg, rt)
        caches = init_cache(cfg, rt, SLOTS, MAX_LEN, dtype=torch.bfloat16)
        step = {"tokens": tokens[:, :1], "index": PROMPT_LEN}
        out["models"][arch] = {
            "layers": cfg.n_layers, "kernel": kernel_name,
            "prefill": device_profile(lambda: prefill(lm, {"tokens": tokens}), kernel,
                                      kernel_name),
            "decode_step": device_profile(lambda: decode(lm, step, caches), kernel,
                                          kernel_name),
        }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
