"""What the port's spans (``repro_torch.telemetry``) cost on the host, off and
on, and whether their records and the profiler's annotations share a clock:

    python benchmarks_torch/span_cost.py [--device cuda] [--out FILE]

Off (no profiler): the time of one ``with telemetry.span(...)`` with and
without shapes, against an empty loop. On (a ``torch.profiler`` over CPU and
CUDA): the time of one empty span, and of one around a small device
operation against the operation alone. Clock: 200 spans around a small
operation; the median and largest gaps between each stored span's start and
end and its profiler annotation's. Prints one JSON object (with the card's
name and power limit from nvidia-smi) and writes it to ``--out``.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def per_call_us(fn, n):
    t = time.perf_counter()
    fn(n)
    return 1e6 * (time.perf_counter() - t) / n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("span_cost: no CUDA device (pass --device cpu to run on the host)")
    x = torch.ones(1024, device=args.device)
    shape = tuple(x.shape)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def empty(n):
        for _ in range(n):
            pass

    def bare(n):
        for _ in range(n):
            with telemetry.span("cost/bare"):
                pass

    def attrs(n):
        for _ in range(n):
            with telemetry.span("cost/attrs", x=shape, n=128, chunk=256):
                pass

    def op(n):
        for _ in range(n):
            x.add_(1.0)

    def op_in_span(n):
        for _ in range(n):
            with telemetry.span("cost/op"):
                x.add_(1.0)

    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu"}
    if cuda:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    for fn in (empty, bare, attrs):
        fn(1000)  # warm
    out["off_us"] = {f.__name__: statistics.median(per_call_us(f, 200_000) for _ in range(5))
                     for f in (empty, bare, attrs)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):
        for fn in (bare, op, op_in_span):
            fn(100)  # warm
        sync()
        on = {}
        for fn in (bare, op, op_in_span):
            on[fn.__name__] = statistics.median(per_call_us(fn, 2000) for _ in range(5))
            sync()
    out["on_us"] = on
    out["on_span_us"] = on["bare"]
    out["on_span_around_op_us"] = on["op_in_span"] - on["op"]
    telemetry.clear()
    with profile(activities=acts) as prof:
        for i in range(200):
            with telemetry.span("cost/clock", i=i):
                x.add_(1.0)
        sync()
    stored = sorted(telemetry.spans(), key=lambda s: s.start_ns)
    notes = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CPU
                    and e.is_user_annotation() and e.name() == "cost/clock"),
                   key=lambda e: e.start_ns())
    starts = [abs(s.start_ns - e.start_ns()) / 1e3 for s, e in zip(stored, notes)]
    ends = [abs(s.end_ns - e.end_ns()) / 1e3 for s, e in zip(stored, notes)]
    out["clock"] = {"spans": len(stored), "annotations": len(notes),
                    "start_gap_us_median": statistics.median(starts),
                    "start_gap_us_max": max(starts),
                    "end_gap_us_median": statistics.median(ends), "end_gap_us_max": max(ends)}
    telemetry.clear()
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return out


if __name__ == "__main__":
    main()
