"""The port's spans (``repro_torch.telemetry``) on the CPU: off outside a
profiler, on the profiler's own clock under one, nested and rooted as the
train and prefill steps open them (the backward's spans included), with the
store's bound counted, and no number of a step changed by tracing."""
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import telemetry
from repro_torch.configs import get_config
from repro_torch.models.layers import Runtime
from repro_torch.models.model import init_params
from repro_torch.serve.step import make_prefill_step
from repro_torch.train.optimizer import adamw
from repro_torch.train.step import make_train_step

CFG = get_config("mamba2-130m").reduced()
RT = Runtime("cpu", torch.float32)
B, S = 2, 512  # two SSD chunks of 256


@pytest.fixture(autouse=True)
def _fresh_store():
    """One torch thread (small CPU ops under a test worker per core) and an
    empty store for each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.clear()
    try:
        yield
    finally:
        telemetry.clear()
        torch.set_num_threads(threads)


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, CFG.vocab, (B, S)))


def _lm():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _train(traced: bool):
    """One train step on a fresh model: (loss, grad_norm, the parameters after
    the update)."""
    lm, opt = _lm(), adamw(lr=1e-3)
    state = opt.init(dict(lm.named_parameters()))
    step = make_train_step(CFG, RT, opt)
    batch = {"tokens": _tokens(1), "labels": _tokens(2)}
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            _, _, metrics = step(lm, state, batch)
    else:
        _, _, metrics = step(lm, state, batch)
    return (metrics["loss"], metrics["grad_norm"],
            {n: p.detach().clone() for n, p in lm.named_parameters()})


def _prefill(traced: bool):
    lm = _lm()
    step = make_prefill_step(CFG, RT)
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            return step(lm, {"tokens": _tokens(3)})
    return step(lm, {"tokens": _tokens(3)})


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _inside(s, outer):
    return outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def test_off_outside_a_profiler_returns_the_shared_null_context():
    a, b = telemetry.span("train/step"), telemetry.span("kernels/ssd.scan", chunks=2)
    assert a is b and a is telemetry._NULL
    with a as got:
        assert got is None
    _prefill(traced=False)
    assert telemetry.spans() == [] and telemetry.dropped() == 0


def test_spans_and_profiler_annotations_share_a_clock():
    """Each stored span is a user annotation of the profile under its own
    name, and their starts and ends agree within 50 us at the median."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(100):
            with telemetry.span("test/clock", i=i):
                torch.ones(64).sum()
    stored = sorted(telemetry.spans(), key=lambda s: s.start_ns)
    notes = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name() == "test/clock"),
                   key=lambda e: e.start_ns())
    assert len(stored) == len(notes) == 100
    assert [s.attrs["i"] for s in stored] == list(range(100))
    starts = [abs(s.start_ns - e.start_ns()) for s, e in zip(stored, notes)]
    ends = [abs(s.end_ns - e.end_ns()) for s, e in zip(stored, notes)]
    assert statistics.median(starts) < 50_000 and statistics.median(ends) < 50_000


def test_train_step_spans_nest_under_the_step():
    _train(traced=True)
    spans = telemetry.spans()
    by = _by_name(spans)
    (step,) = by["train/step"]
    assert step.parent is None and step.root == step.id
    assert {"train/global_norm", "train/optimizer", "kernels/ssd.chunk_fwd",
            "kernels/ssd.chunk_bwd", "kernels/ssd.scan"} <= set(by)
    # two layers: each SSD forward once, again in the backward's recompute ("dots")
    assert len(by["kernels/ssd.chunk_bwd"]) == CFG.n_layers
    assert len(by["kernels/ssd.chunk_fwd"]) == 2 * CFG.n_layers
    for s in spans:
        assert s.root == step.id and _inside(s, step), s
        assert s is step or s.parent is not None
    (fwd, *_) = by["kernels/ssd.chunk_fwd"]
    assert fwd.attrs == {"x": (B, S, CFG.mamba.n_heads(CFG.d_model), CFG.mamba.head_dim),
                         "n": CFG.mamba.d_state, "chunk": 256}
    assert {s.attrs["chunks"] for s in by["kernels/ssd.scan"]} == {S // 256}
    ids = {s.id: s for s in spans}
    for s in spans:  # a parent encloses its child
        if s.parent is not None:
            assert _inside(s, ids[s.parent])


def test_prefill_step_spans_nest_under_the_call():
    _prefill(traced=True)
    by = _by_name(telemetry.spans())
    (call,) = by["serve/prefill"]
    assert set(by) == {"serve/prefill", "kernels/ssd.chunk_fwd", "kernels/ssd.scan"}
    assert len(by["kernels/ssd.chunk_fwd"]) == len(by["kernels/ssd.scan"]) == CFG.n_layers
    for s in by["kernels/ssd.chunk_fwd"] + by["kernels/ssd.scan"]:
        assert s.root == call.id and _inside(s, call)


def test_tracing_changes_no_number():
    loss0, norm0, params0 = _train(traced=False)
    loss1, norm1, params1 = _train(traced=True)
    assert torch.equal(loss0, loss1) and torch.equal(norm0, norm1)
    assert all(torch.equal(params0[n], params1[n]) for n in params0)
    assert torch.equal(_prefill(traced=False), _prefill(traced=True))


def test_a_span_on_another_thread_joins_the_open_root():
    """As the autograd engine's device thread does in a CUDA backward: a span
    opened on a thread with no span open belongs to the open root, under the
    innermost span of the root's thread."""
    threads = []

    def other_thread():
        threads.append(threading.get_ident())
        with telemetry.span("other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("train/step") as root:
            with telemetry.span("inner") as inner:
                t = threading.Thread(target=other_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with telemetry.span("alone") as alone:
            pass
    (other,) = _by_name(telemetry.spans())["other"]
    assert threads and threads[0] != threading.get_ident()
    assert other.root == root.id and other.parent == inner.id
    assert alone.root == alone.id and alone.parent is None


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "LIMIT", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(8):
            with telemetry.span("test/bound"):
                pass
    assert len(telemetry.spans()) == 5 and telemetry.dropped() == 3
    telemetry.clear()
    assert telemetry.spans() == [] and telemetry.dropped() == 0


def test_span_cost_script_runs_on_the_host():
    """``benchmarks_torch/span_cost.py`` on the CPU: a span off costs less
    than one on, and its records keep the profiler's clock."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks_torch" / "span_cost.py"
    spec = importlib.util.spec_from_file_location("span_cost", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu"])
    assert out["off_us"]["bare"] < out["on_us"]["bare"]
    assert out["clock"]["spans"] == out["clock"]["annotations"] == 200
    assert out["clock"]["start_gap_us_median"] < 50 and out["clock"]["end_gap_us_median"] < 50
    assert telemetry.spans() == []
