"""How far the MoE model's prefill logits move between the flash kernel and
its plain version, with the routing free and held equal.

    PYTHONPATH=src python benchmarks_torch/moe_routing.py [--out FILE]

moonshot-v1-16b-a3b (``chip_smoke.py``'s ``MOE_ARCH``) at full width and
depth with random bf16 weights from a seeded generator on the CUDA device,
one prefill of SLOTS x PROMPT_LEN tokens (``chip_smoke.py``'s shape and
prompts), at the config's capacity factor and dropless (cf = E / top_k).
For each: the kernel route (``attn_backend="auto"``) and the plain route
(``"reference"``) run free, and each route again with the other route's
expert ids (``moe.replaying_routes``). Reports the distance of their logits
relative to max |logit| at the last position and over all positions, the
share of (layer, token, slot) expert ids that differ between the free
routes per layer, the share of tokens whose set of experts differs, and the
share of slots past capacity; whether the kernel route repeats bit for bit.

Prints one JSON object, with nvidia-smi's "name, power.limit" (and writes it
to ``--out`` when given). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import MOE_ARCH, PROMPT_LEN, SEED, SLOTS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import Runtime  # noqa: E402
from repro_torch.models.model import apply_lm, init_params  # noqa: E402


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@torch.inference_mode()
def compare(lm, cfg, tokens):
    """The two routes free and with each other's expert ids."""
    routes = {name: Runtime("cuda", torch.bfloat16, backend)
              for name, backend in (("kernel", "auto"), ("plain", "reference"))}

    def run(name, replay=None):
        held = contextlib.nullcontext() if replay is None else moe.replaying_routes(replay)
        with moe.recording_routes() as ids, held:
            logits, _ = apply_lm(lm, cfg, routes[name], tokens)
        return logits.float(), torch.stack(ids)  # (B, S, V), (L, B, S, k)

    kernel, ids_k = run("kernel")
    again, ids_again = run("kernel")
    repeats = torch.equal(kernel, again) and torch.equal(ids_k, ids_again)
    del again
    plain, ids_p = run("plain")
    plain_held, _ = run("plain", list(ids_k))
    kernel_held, _ = run("kernel", list(ids_p))
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    C = moe._capacity(tokens.numel(), k, E, cfg.moe_cf)
    flips = (ids_k != ids_p).flatten(1).float().mean(dim=1)
    set_flips = (ids_k.sort(-1).values != ids_p.sort(-1).values).any(-1).flatten(1)
    dropped = torch.stack([moe._dispatch_positions(ids.reshape(-1), E) >= C for ids in ids_k])
    return {
        "moe_cf": cfg.moe_cf, "capacity": C, "kernel_route_repeats_bit_for_bit": repeats,
        "free": {"last": rel(kernel[:, -1], plain[:, -1]), "all": rel(kernel, plain)},
        "plain_takes_kernel_ids": {"last": rel(kernel[:, -1], plain_held[:, -1]),
                                   "all": rel(kernel, plain_held)},
        "kernel_takes_plain_ids": {"last": rel(kernel_held[:, -1], plain[:, -1]),
                                   "all": rel(kernel_held, plain)},
        "top1_agreement_last_free": float((kernel[:, -1].argmax(-1)
                                           == plain[:, -1].argmax(-1)).float().mean()),
        "max_abs_logit": float(plain.abs().max()),
        "expert_id_flip_share": float(flips.mean()),
        "expert_id_flip_share_per_layer": [round(float(x), 4) for x in flips],
        "expert_set_flip_share_per_layer": [round(float(x), 4)
                                            for x in set_flips.float().mean(dim=1)],
        "dropped_slot_share": float(dropped.float().mean()),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_routing: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = get_config(MOE_ARCH)
    lm = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED), torch.bfloat16,
                     "cuda")
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SLOTS, PROMPT_LEN), dtype=np.int32), device="cuda")
    dropless = dataclasses.replace(cfg, moe_cf=float(cfg.moe.n_experts / cfg.moe.top_k))
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "arch": MOE_ARCH,
           "tokens": [SLOTS, PROMPT_LEN],
           "config_cf": compare(lm, cfg, tokens), "dropless": compare(lm, dropless, tokens)}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
