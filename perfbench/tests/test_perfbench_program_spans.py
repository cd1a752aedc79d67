"""The program's own spans in the benchmark, on the CPU: a spec for a range
the program opens itself patches nothing the run calls and is read by its
label; the five readers of the program's spans on made-up runs; and a
traced small run whose store gives the four host times."""
import sys
import time
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
sys.path[:0] = [str(HERE / "tests"), str(HERE), str(REPO / "src")]

import program_spans  # noqa: E402
import tiny  # noqa: E402

SEED = 2**33 + 211
HOST_READERS = {"norm_wait_ms.train": ("train/global_norm", "train/step"),
                "optimizer_launch_ms.train": ("train/optimizer", "train/step"),
                "ssd_bwd_host_ms.train": ("kernels/ssd.chunk_bwd", "train/step"),
                "ssd_scan_host_ms.prefill": ("kernels/ssd.scan", "serve/prefill")}


def _reader(name):
    import harness

    return harness.load_module(HERE / "metrics" / f"{name}.py")


def test_a_range_the_program_opens_patches_nothing_and_is_read_by_its_label():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry
    from repro_torch.kernels import ops
    from spans import WINDOW, Ranges, reduce

    specs = program_spans.own("test/own", "test/root")
    before = dict(vars(ops))
    with profile(activities=[ProfilerActivity.CPU]) as prof, Ranges(specs, {}).installed():
        assert vars(ops) == before
        with torch.profiler.record_function(WINDOW):
            for _ in range(3):
                with telemetry.span("test/root"), telemetry.span("test/own"):
                    torch.ones(8).sum()
    assert vars(ops) == before
    telemetry.clear()
    trace = reduce(prof, specs)
    assert trace["calls"]["test/own"] == trace["calls"]["test/root"] == 3
    assert trace["operations"] == 0  # no device here: nothing to charge a gap to


def _span(sid, name, t0_ms, t1_ms, root, attrs=None):
    from repro_torch.telemetry import Span

    base = time.time_ns()
    return Span(sid, name, base + round(t0_ms * 1e6), base + round(t1_ms * 1e6),
                None if sid == root else root, root, attrs or {})


def _ctx(device="cuda", device_s=None):
    now = time.perf_counter()
    return types.SimpleNamespace(device=device, record={"t0": now - 1.0, "t_end": now + 1.0},
                                 trace={"device_s": device_s or {}})


X = (8, 4096, 24, 64)
SPANS = [
    _span(0, "train/step", 0, 100, 0), _span(1, "train/global_norm", 80, 85, 0),
    _span(2, "train/optimizer", 85, 99, 0), _span(3, "kernels/ssd.chunk_bwd", 40, 41, 0),
    _span(4, "kernels/ssd.chunk_bwd", 41, 43, 0),
    _span(10, "train/step", 100, 200, 10), _span(11, "train/global_norm", 180, 187, 10),
    _span(12, "train/optimizer", 187, 197, 10),
    _span(20, "serve/prefill", 200, 300, 20), _span(21, "kernels/ssd.scan", 210, 214, 20),
    _span(22, "kernels/ssd.chunk_fwd", 205, 206, 20, {"x": X, "n": 128, "chunk": 256}),
    _span(23, "kernels/ssd.chunk_fwd", 215, 216, 20, {"x": X, "n": 128, "chunk": 256}),
    _span(24, "train/global_norm", 250, 260, 20),  # not inside a train step: left out
]


@pytest.mark.parametrize("name,want", [("norm_wait_ms.train", 6.0),
                                       ("optimizer_launch_ms.train", 12.0),
                                       ("ssd_bwd_host_ms.train", 1.5),
                                       ("ssd_scan_host_ms.prefill", 4.0)])
def test_host_time_readers_on_a_made_up_run(monkeypatch, name, want):
    monkeypatch.setattr(program_spans, "stored", lambda ctx: SPANS)
    reader = _reader(name)
    assert reader.read(_ctx()) == pytest.approx(want, rel=1e-6)
    assert set(reader.RANGES) == set(HOST_READERS[name])
    assert reader.read(_ctx(device="cpu")) is None  # the host's own work there, not a wait


def test_chunk_roofline_reader_on_a_made_up_run(monkeypatch):
    import work

    monkeypatch.setattr(program_spans, "stored", lambda ctx: SPANS)
    reader = _reader("ssd_chunk_roofline.prefill")
    least = work.least_time(*work.ssd_step_call(X, 128, 256, backward=False),
                            work.PEAK_F32_PRODUCT_FLOPS)
    got = reader.read(_ctx(device_s={"kernels/ssd.chunk_fwd": 4 * least}))
    assert got == pytest.approx(50.0)
    assert reader.read(_ctx(device_s={})) is None
    assert set(reader.RANGES) == {"kernels/ssd.chunk_fwd", "serve/prefill"}


@pytest.mark.parametrize("name", [*HOST_READERS, "ssd_chunk_roofline.prefill"])
def test_readers_read_nothing_from_a_program_without_its_own_spans(monkeypatch, name):
    import repro_torch

    monkeypatch.delattr(repro_torch, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)  # import fails
    assert program_spans.stored(_ctx()) is None
    assert _reader(name).read(_ctx(device_s={"kernels/ssd.chunk_fwd": 1.0})) is None


def test_stored_keeps_the_window_and_refuses_a_store_that_dropped(monkeypatch):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("test/before"):
            pass
        time.sleep(0.2)
        t0 = time.perf_counter()
        with telemetry.span("test/inside"):
            torch.ones(2).sum()
        t_end = time.perf_counter()
    ctx = types.SimpleNamespace(record={"t0": t0, "t_end": t_end})
    assert [s.name for s in program_spans.stored(ctx)] == ["test/inside"]
    monkeypatch.setattr(telemetry, "_dropped", 1)
    assert program_spans.stored(ctx) is None
    telemetry.clear()


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.make_bench(tmp_path_factory.mktemp("bench"))


def _traced(bench, name):
    import harness

    got = {}
    res = harness.run(tiny.cell(bench, name), SEED, 3.0, True, device="cpu",
                      t_start=time.perf_counter(),
                      device_info={"platform": "cpu", "kind": "cpu", "count": 1},
                      after=lambda ctx, state: got.update(ctx=ctx))
    return res, got["ctx"]


@pytest.mark.parametrize("name,kind", [("tiny-mamba.tiny-train", "train"),
                                       ("tiny-mamba.tiny-prefill", "prefill")])
def test_a_traced_small_run_gives_the_host_times(bench, name, kind):
    """The store of a traced CPU run gives each host time of its kind, and as
    many root spans as the profile has root ranges; the readers themselves
    read nothing on the CPU."""
    res, ctx = _traced(bench, name)
    assert res["correct"] is True
    spans = program_spans.stored(ctx)
    for metric, (span, root) in HOST_READERS.items():
        if metric.endswith(kind):
            assert program_spans.host_ms(spans, span, root) > 0, metric
            assert metric not in res["metrics"]
            roots = [s for s in spans if s.name == root and s.root == s.id]
            assert ctx.trace["calls"][root] == len(roots) > 0
            assert ctx.trace["calls"][span] == sum(s.name == span for s in spans)
