"""Readings that the limits of a cell's check are set from, in one process:
for each seed, every number the check works out for a sound run of the
program, for the control (the reference computed with float8 products, put
in the program's place), and for each fault the cell can have
(``faults.py``) planted in the program.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 28 \\
        [--control-seeds 1,2,3] [--faults half_batch,token_altered] [--out FILE]

Prints one JSON line a reading and writes them all to ``--out``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--bench", type=Path, default=ROOT / "BENCHMARK.json")
    args = ap.parse_args()
    sys.path[:0] = [str(args.bench.parent / "perfbench"), str(ROOT / "src")]
    import faults
    import harness
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.load_cell(args.workload, args.bench, args.bench.parent / "perfbench")
    plant = faults.for_entry(cell.mix["entry"])
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    rows, first = [], True

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        got = {}

        def after(ctx, state):
            got["numbers"] = ctx.numbers
            if seed in control_seeds:
                got["control"] = ctx.entry.control(ctx, state)

        t = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, device=device, t_start=t, warm=first,
                          after=after)
        first = False
        emit({"seed": seed, "kind": "program", "correct": res["correct"],
              "numbers": got["numbers"],
              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "seconds": time.perf_counter() - t})
        if "control" in got:
            emit({"seed": seed, "kind": "control", "numbers": got["control"]})
        for name in (f for f in args.faults.split(",") if f and seed in fault_seeds):
            with plant[name]():
                res = harness.run(cell, seed, args.seconds, False, device=device,
                                  t_start=time.perf_counter(), warm=False,
                                  after=lambda ctx, state: got.update(fault=ctx.numbers))
            emit({"seed": seed, "kind": f"fault:{name}", "correct": res["correct"],
                  "numbers": got["fault"]})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
