"""Spans and the device trace of a ``--trace 1`` run.

``Ranges`` puts a ``torch.profiler.record_function`` range around each
program function it is given (a module's global or a class's method, looked
up at call time by the program's callers), for the traced window only. A
range may also close its calls by ``torch.cuda.synchronize()`` and keep
their host wall times, and may record each call's work (operations, bytes,
peak) from its arguments' shapes.

``reduce`` reads the profiler's events: each device operation (kernel, copy,
set) is tied to the host thread and time of its launch by its correlation
id, and so to the ranges open there; a range's device time is the time of
the operations launched inside it. Busy time is the union of the device's
operations over the traced window; idle gaps are charged to the innermost
range open where the operation after the gap was launched.
"""
from __future__ import annotations

import collections
import contextlib
import importlib
import time

import torch

WINDOW = "perfbench.window"
TOP = 10


def resolve(target: str, modules: dict):
    """``"module:attr.path"`` -> (owner, name, current value); ``modules``
    names modules that are not importable by name (the entry)."""
    mod_name, _, path = target.partition(":")
    owner = modules[mod_name] if mod_name in modules else importlib.import_module(mod_name)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name, getattr(owner, name)


class Ranges:
    """``specs``: label -> {"target": "module:attr", "sync": bool, "work":
    callable(*args, **kwargs) -> (flops, bytes, peak) or None}."""

    def __init__(self, specs: dict, modules: dict):
        self.specs, self.modules = specs, modules
        self.host_s = collections.defaultdict(list)
        self.work = collections.defaultdict(list)
        self._saved = []

    def _wrap(self, label, spec, fn):
        sync, work = spec.get("sync", False) and torch.cuda.is_available(), spec.get("work")
        host_s, works = self.host_s[label], self.work[label]

        def wrapped(*args, **kwargs):
            if work is not None:
                works.append(work(*args, **kwargs))
            if sync:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
            if sync:
                host_s.append(time.perf_counter() - t0)
            return out

        return wrapped

    @contextlib.contextmanager
    def installed(self):
        try:
            for label, spec in self.specs.items():
                owner, name, fn = resolve(spec["target"], self.modules)
                raw = owner.__dict__.get(name, fn) if isinstance(owner, type) else fn
                new = self._wrap(label, spec, fn)
                setattr(owner, name, staticmethod(new) if isinstance(raw, staticmethod) else new)
                self._saved.append((owner, name, raw))
            yield self
        finally:
            for owner, name, raw in reversed(self._saved):
                setattr(owner, name, raw)
            self._saved.clear()


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce(prof, labels) -> dict:
    """The traced window's device busy time, each range's device time
    (inclusive of nested ranges) and host calls, the operations with the
    most time and the idle gaps by range. Times in seconds."""
    labels = set(labels) | {WINDOW}
    events = prof.profiler.kineto_results.events()
    cpu_type = torch.autograd.DeviceType.CPU
    annotations = {e.name() for e in events if e.device_type() == cpu_type
                   and e.is_user_annotation()}
    ranges = collections.defaultdict(list)  # thread -> [(start, end, label)]
    launches = collections.defaultdict(list)  # thread -> [(start, correlation)]
    device = []  # (start, end, correlation, name)
    for e in events:
        if e.device_type() == cpu_type:
            name = e.name()
            if e.is_user_annotation():
                if name in labels:
                    ranges[e.start_thread_id()].append((e.start_ns(), e.end_ns(), name))
            elif name.startswith("cu"):
                launches[e.start_thread_id()].append((e.start_ns(), e.correlation_id()))
        elif e.name() not in annotations:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id(),
                           e.name()))
    window = [r for rs in ranges.values() for r in rs if r[2] == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"trace: {len(window)} window ranges, want 1")
    w0, w1 = window[0][0], window[0][1]
    # the ranges open at each launch: a sweep over each thread's ranges
    stack_of = {}
    for tid, ls in launches.items():
        rs = sorted(ranges.get(tid, []))
        ls.sort()
        open_, i = [], 0
        for t, corr in ls:
            while i < len(rs) and rs[i][0] <= t:
                open_.append(rs[i])
                i += 1
            open_ = [r for r in open_ if r[1] >= t]
            stack_of[corr] = tuple(r[2] for r in sorted(open_))
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    device.sort()
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in device])
    inclusive = collections.Counter()
    by_name = collections.Counter()
    unattributed = 0
    for s, e, corr, name in device:
        dur = min(e, w1) - max(s, w0)
        by_name[name[:120]] += dur
        stack = stack_of.get(corr)
        if stack is None:
            unattributed += 1
            continue
        for label in set(stack):
            inclusive[label] += dur
    gaps = collections.Counter()
    end = w0
    for s, e, corr, _ in device:
        if s > end:
            stack = stack_of.get(corr) or ("(no range)",)
            gaps[[l for l in stack if l != WINDOW][-1] if len(stack) > 1 else stack[-1]] += s - end
        end = max(end, e)
    if w1 > end:
        gaps["(after the last operation)"] += w1 - end
    calls = collections.Counter(r[2] for rs in ranges.values() for r in rs)
    ns = 1e-9
    return {
        "window_s": (w1 - w0) * ns, "busy_s": busy * ns,
        "device_s": {k: v * ns for k, v in inclusive.items()},
        "calls": dict(calls), "operations": len(device), "unattributed": unattributed,
        "device_ops": [[k, v * ns] for k, v in by_name.most_common(TOP)],
        "idle_gaps": [[k, v * ns] for k, v in gaps.most_common(TOP)],
    }
