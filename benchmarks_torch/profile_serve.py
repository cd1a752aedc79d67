"""Where the time of serving gemma-2b, mamba2-130m and moonshot-v1-16b-a3b
goes on the GPU.

    PYTHONPATH=src python benchmarks_torch/profile_serve.py [--out FILE]

For gemma-2b, mamba2-130m and moonshot-v1-16b-a3b (``chip_smoke.py``'s
``FULL_ARCH``, ``SSM_ARCH`` and ``MOE_ARCH``) at full width and depth (random
bf16 weights from a seeded generator, bf16 compute, ``attn_backend="auto"``)
on the CUDA device, one model at a time, at the serving shape that
``chip_smoke.py`` checks (its ``SLOTS``, ``PROMPT_LEN`` and ``MAX_LEN``),
after one warm-up of each: a torch.profiler trace of one prefill of SLOTS x
PROMPT_LEN tokens (``make_prefill_step``, the Engine's prefill) and one of a
decode step over a MAX_LEN-token cache (``make_decode_step``). For each: host
wall time (closed by torch.cuda.synchronize()), device busy time (sum of
kernel times), the device's idle share of the wall, kernel launches, the
model's hand-written kernel's launches, device time and share (flash
attention for gemma-2b and moonshot-v1-16b-a3b, the SSD chunk kernel for
mamba2-130m), and the kernels with the most device time. For
moonshot-v1-16b-a3b also the device time of the kernels launched inside
the MoE block's expert products (``moe._expert_ffn``), the rest of the MoE
block (router, top-k, aux, dispatch and combine) and the head
(``model._head``), from profiler ranges put around those functions for the
traced run only.

Prints one JSON object, with nvidia-smi's "name, power.limit" (and writes it
to ``--out`` when given). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
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

from chip_smoke import (FULL_ARCH, MAX_LEN, MOE_ARCH, PROMPT_LEN, SEED, SLOTS,  # noqa: E402
                        SSM_ARCH)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention, ssd  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.models.model import init_cache, init_params  # noqa: E402
from repro_torch.serve.step import make_decode_step, make_prefill_step  # noqa: E402

TOP = 10  # kernels listed by device time
# each model's hand-written kernel: its host module and a part of its CUDA
# functions' names ("flash_fwd": flash_fwd_wgmma in bf16, flash_fwd_tf32 in f32)
KERNELS = {FULL_ARCH: (flash_attention, "flash_fwd"),
           SSM_ARCH: (ssd, "ssd_chunk_kernel"),
           MOE_ARCH: (flash_attention, "flash_fwd")}
# profiler ranges of the MoE model: label -> (module, function); a kernel
# counts toward the innermost range it was launched in
SPANS = {MOE_ARCH: {"moe_expert_products": (moe, "_expert_ffn"),
                    "moe_router_dispatch_combine": (moe, "apply_moe"),
                    "head": (model_mod, "_head")}}


@contextlib.contextmanager
def ranges(spans):
    """Puts a profiler range named after its label around each function of
    ``spans`` (the module's global, which its callers look up at call time)
    until the block ends."""
    saved = []
    for label, (mod, name) in spans.items():
        fn = getattr(mod, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            with torch.profiler.record_function(_label):
                return _fn(*args, **kwargs)

        setattr(mod, name, wrapped)
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def span_device_ms(events, labels):
    """Device ms of the kernels launched by the operators inside each
    labelled range (the innermost one). Kernels launched outside any
    operator (the ctypes-launched flash and SSD kernels) are in none."""
    out = dict.fromkeys(labels, 0.0)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        node = e
        while node is not None and node.name not in out:
            node = node.cpu_parent
        if node is not None:
            out[node.name] += sum(k.duration for k in e.kernels) / 1e3
    return out


def device_profile(fn, kernel, kernel_name, spans=None):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

    fn()  # warm-up
    torch.cuda.synchronize()
    telemetry.clear()
    launches0 = kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            ranges(spans or {}):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events, less the device-side copies of the profiler ranges and
    # of the program's own spans
    labels = set(spans or {}) | {s.name for s in telemetry.spans()}
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in labels]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    kernel_ms = sum(v[0] for k, v in by_name.items() if kernel_name in k)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    out = {
        "wall_ms": 1e3 * wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall), "device_kernels": len(kernels),
        "kernel_launches": kernel.launches - launches0, "kernel_device_ms": kernel_ms,
        "kernel_share_of_busy": kernel_ms / busy_ms if busy_ms else 0.0,
        "top_kernels": [{"name": k[:90], "ms": v[0], "count": v[1]} for k, v in ranked[:TOP]],
    }
    if spans:
        parts = span_device_ms(prof.events(), spans)
        parts[kernel_name] = kernel_ms
        parts["other"] = busy_ms - sum(parts.values())
        out["device_ms_by_part"] = parts
    return out


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
        spans = SPANS.get(arch)
        out["models"][arch] = {
            "layers": cfg.n_layers, "kernel": kernel_name,
            "prefill": device_profile(lambda: prefill(lm, {"tokens": tokens}), kernel,
                                      kernel_name, spans),
            "decode_step": device_profile(lambda: decode(lm, step, caches), kernel,
                                          kernel_name, spans),
        }
        del lm, caches
        gc.collect()
        torch.cuda.empty_cache()
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
