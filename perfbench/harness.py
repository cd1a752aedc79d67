"""The benchmark's driver: finds a cell's parts by name, runs its set-up and
its measured window, reads its metrics, and decides ``correct``.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell is a file of its own under the benchmark's folder, found by the
names in ``BENCHMARK.json``:

  configs/<config>.json      the configuration: the source's numbers, the
                             program's fields (``program``), its dtypes and
                             the family of its plain reference
  reference/<family>.py      the plain float32 reference of that family
  traffic/<mix>.json         the mix's parameters, read by ``traffic.py``,
                             and the entry that drives it
  entries/<entry>.py         set-up, window and check of one kind of entry
                             into the program (prefill, train)
  metrics/<metric>.py        a reader: ``read(ctx) -> number or None``, and
                             the ranges it needs in the traced run
  checks/<cell>.json         the numbers the cell compares, with their limits

A later change adds a configuration, a mix, a metric or a cell by adding
such files and entries in ``BENCHMARK.json``, and edits none.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_module(path: Path, name: str | None = None):
    """Imports a file by its path (names with dots and dashes included)."""
    path = Path(path).resolve()
    name = name or "perfbench_" + hashlib.sha1(str(path).encode()).hexdigest()[:12]
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    root: Path  # the benchmark's folder
    bench: dict
    workload: dict
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    checks: dict  # checks/<cell>.json
    end_to_end: list
    per_layer: list

    @property
    def prog(self) -> dict:
        return self.config["program"]


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, bench_file: Path, root: Path | None = None) -> Cell:
    bench = json.loads(Path(bench_file).read_text())
    root = Path(root) if root is not None else HERE
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((bench_file.parent / cfg_entry["file"]).read_text())
    mix = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    checks = json.loads((root / "checks" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name, root, bench, w, config, mix, checks, e2e, per_layer)


class Context:
    """What an entry and a reader see: the cell, the run's seed and device,
    the reference module, and what the run has measured so far."""

    def __init__(self, cell: Cell, seed: int, device: str, t_start: float, warm: bool):
        import work

        self.cell, self.seed, self.device, self.t_start = cell, int(seed), device, t_start
        self.warm = warm  # whether set-up warms every shape (calibration warms once)
        self.work = work
        self.reference = importlib.import_module(f"reference.{cell.config['reference']}")
        self.entry = load_module(cell.root / "entries" / f"{cell.mix['entry']}.py")
        self.setup_s = None
        self.peak_bytes = None
        self.record = None  # the window's record (entries' own)
        self.trace = None  # spans.reduce's summary (traced runs)
        self.numbers = None  # every number the check works out, compared or not
        self.ranges = None  # spans.Ranges (traced runs)

    @property
    def prog(self) -> dict:
        return self.cell.prog

    def mark(self, what: str):
        """Logs the seconds since the process started, at a step of set-up."""
        _log(f"{what} at {time.perf_counter() - self.t_start:.3f} s")


def metric_readers(cell: Cell, traced: bool) -> dict:
    chosen = cell.per_layer if traced else cell.end_to_end
    return {m["name"]: load_module(cell.root / "metrics" / f"{m['name']}.py") for m in chosen}


def compare(numbers: dict, checks: dict) -> tuple[bool, dict]:
    """Each number against its limit (a number at or below its limit passes);
    a number the cell names and the run did not give fails."""
    out, ok = {}, True
    for name, spec in checks["numbers"].items():
        value = numbers.get(name)
        finite = value is not None and math.isfinite(value)
        ok &= finite and value <= spec["limit"]
        # a number that is not finite prints as null (JSON has no infinity)
        out[name] = {"value": value if finite else None, "limit": spec["limit"]}
    return ok, out


def _no_jax():
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: {bad}")


def _log(msg: str):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, traced: bool, *, device: str, t_start: float,
        device_info=None, warm: bool = True, after=None) -> dict:
    """One run of ``cell``: set-up, the window, the metrics, the check.
    Returns the result's object (without printing it). ``after(ctx,
    state)``, where given, runs once the check is done (calibration reads
    the control there)."""
    import torch

    sys.path.insert(0, str(cell.root))
    from spans import WINDOW, Ranges, reduce

    ctx = Context(cell, seed, device, t_start, warm)
    _no_jax()
    readers = metric_readers(cell, traced)
    entry = ctx.entry
    state = entry.setup(ctx)
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ctx.setup_s = time.perf_counter() - t_start
    _log(f"set-up {ctx.setup_s:.3f} s")
    if traced:
        specs = dict(getattr(entry, "RANGES", {}))
        for r in readers.values():
            specs.update(getattr(r, "RANGES", {}))
        ctx.ranges = Ranges(specs, {"entry": entry})
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof, ctx.ranges.installed():
            with torch.profiler.record_function(WINDOW):
                ctx.record = entry.window(ctx, state, seconds)
        t = time.perf_counter()
        ctx.trace = reduce(prof, specs)
        del prof
        _log(f"trace: {ctx.trace['operations']} device operations, "
             f"{ctx.trace['unattributed']} not tied to a launch, ranges {ctx.trace['calls']}, "
             f"read in {time.perf_counter() - t:.1f} s")
    else:
        ctx.record = entry.window(ctx, state, seconds)
    if cuda:
        ctx.peak_bytes = torch.cuda.max_memory_allocated()
    values = {}
    for name, reader in readers.items():
        v = reader.read(ctx)
        if v is not None:
            values[name] = v
    _no_jax()
    entry.release(ctx, state)
    t = time.perf_counter()
    numbers = ctx.numbers = entry.check(ctx, state)
    _log(f"check: {numbers} in {time.perf_counter() - t:.1f} s")
    correct, checks = compare(numbers, cell.checks)
    if after is not None:
        after(ctx, state)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result = {
        "correct": bool(correct and ctx.record["failed"] == 0),
        "attempted": ctx.record["attempted"],
        "failed": ctx.record["failed"],
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
        "device": dict(device_info or {}, memory_peak_bytes=ctx.peak_bytes),
    }
    if traced:
        result["device"].update(busy_s=ctx.trace["busy_s"], window_s=ctx.trace["window_s"])
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["checks"] = checks
    return result
