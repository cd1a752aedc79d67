"""One run of one cell of the benchmark of the PyTorch and CUDA port.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Makes the cell's inputs and weights from
``--seed`` on the CUDA device, warms up, measures for ``--seconds``, checks
what the measured window produced against the plain reference, and prints
one JSON object as the last line of standard output (with ``--trace 1`` the
per-layer metrics of a profiled window instead of the end-to-end ones).
Exits non-zero and prints no result without enough CUDA devices, if JAX or
the JAX package is loaded, or on any error. Kernel builds and caches stay
inside the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "out" / "cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT / "src")]

    import repro_torch  # noqa: F401  (the program under test: a checkout without it fails here)

    import harness
    import torch

    cell = harness.load_cell(args.workload, ROOT / "BENCHMARK.json", HERE)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"run: {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
          f"nvidia-smi: {smi}", file=sys.stderr)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                         t_start=T_START, device_info=info)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    result["nvidia_smi"] = smi
    result["checks"] = checks
    for name, c in checks.items():
        print(f"{name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
