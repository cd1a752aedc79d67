"""``chip_smoke.py``'s phase 23 (the sharded train step, four ranks sharing
the card over gloo) alone, as the script runs it:

    python benchmarks_torch/mesh_train_phase.py [--reps 2] [--profile]

Keeps the bytecode it compiles under ``build/pycache`` as ``chip_smoke.py``
does, builds the flash and SSD kernels, prints the card's name and power
limit, then runs ``mesh_train_phase`` ``--reps`` times in one process and
prints each run's wall clock, parts and start-up. With ``--profile`` it
first runs part (a)'s golden training runs on four ranks with rank 0 under
cProfile: each entry's seconds and collectives, then the functions with the
most own time (collectives, compiling modules, the model's Python).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"] = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile_rank(rank, world, golden_path, device):
    """Part (a)'s golden runs on this rank, rank 0 under cProfile: (per
    entry (seconds, collectives), the profile's top lines or None)."""
    import cProfile
    import io
    import pstats

    import torch

    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    golden = json.loads(Path(golden_path).read_text())
    mesh = make_smoke_mesh(2, 2, device_type=device)
    prof, walls = cProfile.Profile(), {}
    for name, entry in golden["entries"].items():
        t = time.perf_counter()
        if rank == 0:
            prof.enable()
        with C.c10d_calls() as calls:
            C.mesh_train_curve(get_config(entry["arch"]).reduced(), golden["setup"], mesh,
                               device, entry.get("routes"))
        prof.disable()
        walls[name] = (time.perf_counter() - t, sum(n for n, _ in calls.values()))
    if rank != 0:
        return walls, None
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
    return walls, out.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import subprocess

    import chip_smoke as C
    from repro_torch.kernels import flash_attention, ssd
    from repro_torch.launch.mesh import spawn

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
        for kernel in (flash_attention, ssd):
            kernel.build()
    if args.profile:
        recs = spawn(profile_rank, 4, backend="gloo", device=args.device,
                     args=(str(C.TRAIN_GOLDEN), args.device), timeout=900)
        print("part (a) on rank 0, (s, collectives) an entry:",
              {k: (round(s, 2), n) for k, (s, n) in recs[0][0].items()}, flush=True)
        print(recs[0][1], flush=True)
    golden = json.loads(C.TRAIN_GOLDEN.read_text())
    for rep in range(args.reps if args.device == "cuda" else 0):
        t = time.perf_counter()
        C.mesh_train_phase(golden)
        print(f"rep {rep}: phase {time.perf_counter() - t:.2f} s at {C.MESH_TRAIN_LAYERS} "
              "layers", flush=True)


if __name__ == "__main__":
    main()
