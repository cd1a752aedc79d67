"""Device times of the crms_grid and float32 flash-attention kernels of one
source tree, for comparing two trees on one card.

    python benchmarks_torch/time_kernels.py [--src DIR]

Imports ``repro_torch`` from ``--src`` (default: this checkout's ``src``),
builds its kernels into that tree's ``build/`` and runs ``chip_smoke.py``'s
checks of them against their plain versions on the card, timed: crms_grid at
the grid-seeding shape (72, 64) per-app and at a search-sized (20000, 64) in
sum mode, flash attention in float32 at the serving shape (B 4, S 512, KV 1,
G 8, hd 256), causal and not, beside ``scaled_dot_product_attention`` in
float32, and
the graph-replayed launch floor (``chip_smoke.launch_floor_ms``). To compare
a parent commit with a change, unpack the parent into a directory that
``.gitignore`` lists (``scratch_chip/``) and run this script in turns, in one
call: ``--src scratch_chip/parent/src``, ``--src src``, ``--src src``,
``--src scratch_chip/parent/src``.

Prints nvidia-smi's "name, power.limit" and one JSON object. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="directory holding repro_torch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.kernels import crms_grid, flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for kernel in (crms_grid, flash_attention):
        kernel.build(force=True)
    per_app = smoke.check_kernel(72, 64, "per_app", reps=2000, plain_reps=2)
    summed = smoke.check_kernel(20000, 64, "sum", reps=200, plain_reps=1, n_range=(8, 20))
    flash = smoke.check_flash(4, 512, 512, 1, 8, 256, True, torch.float32, timed=True)
    full = smoke.check_flash(4, 512, 512, 1, 8, 256, False, torch.float32, timed=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({
        "source": str(Path(args.src).resolve()),
        "crms_grid_per_app_graph_ms": per_app["graph_ms"],
        "crms_grid_sum_graph_ms": summed["graph_ms"],
        "flash_f32_graph_ms": flash["graph_ms"],
        "flash_f32_max_abs_err": flash["max_abs_err"],
        "sdpa_f32_graph_ms": flash["library_graph_ms"],
        "flash_f32_bound_ms": flash["bound_ms"],
        "flash_f32_noncausal_graph_ms": full["graph_ms"],
        "sdpa_f32_noncausal_graph_ms": full["library_graph_ms"],
        "launch_floor_graph_ms": smoke.launch_floor_ms(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
