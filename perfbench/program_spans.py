"""The program's own spans (``repro_torch.telemetry``) in a traced run.

The program opens a ``torch.profiler.record_function`` range for each of
its spans while a profiler records, and keeps a record of each (name, start
and end on the profiler's clock, root, shapes) in a store of its own.

A reader names such a range in its ``RANGES`` by the span's name, with
``OWN`` as the spec (``own(*names)``). ``spans.Ranges`` installs a spec by
patching its target; ``OWN``'s target, ``opened_by_the_program``, is a
function nothing calls, so installing it changes nothing the run calls, and
``spans.reduce`` reads the program's range by its label: its device time,
its calls and the idle gaps charged to it.

``stored`` gives the program's records of the traced window; a program
without its own spans gives None, and its readers read nothing.
"""
from __future__ import annotations

import time

SLACK_NS = 50_000_000  # the window's edges, moved from one clock to another


def opened_by_the_program():
    """Never called: the target of ``OWN``."""


OWN = {"target": "program_spans:opened_by_the_program"}


def own(*names) -> dict:
    """``RANGES`` entries for ranges the program opens itself."""
    return {name: OWN for name in names}


def stored(ctx) -> list | None:
    """The program's stored spans that started inside the traced window
    (``ctx.record``'s ``t0`` .. ``t_end``, host perf-counter seconds); None
    without ``repro_torch.telemetry`` or where its store dropped spans."""
    try:
        from repro_torch import telemetry
    except ImportError:  # a program that opens no spans of its own
        return None
    if telemetry.dropped():
        return None
    shift = time.time_ns() - time.perf_counter_ns()
    w0, w1 = (round(ctx.record[k] * 1e9) + shift for k in ("t0", "t_end"))
    return [s for s in telemetry.spans() if w0 - SLACK_NS <= s.start_ns <= w1 + SLACK_NS]


def host_ms(spans, name: str, root: str) -> float | None:
    """The host's ms inside span ``name`` per call of the root span
    ``root``, over the calls ``spans`` holds; None where it holds none of
    either."""
    roots = {s.id for s in spans or () if s.name == root and s.root == s.id}
    inner = [s.end_ns - s.start_ns for s in spans or () if s.name == name and s.root in roots]
    if not roots or not inner:
        return None
    return sum(inner) / 1e6 / len(roots)


def host_ms_on_card(ctx, name: str, root: str) -> float | None:
    """``host_ms`` of the traced window on a CUDA device. Where the host runs
    the work itself (no device), a span's time is that work, not the host's
    part of the card's: nothing is read."""
    if not str(ctx.device).startswith("cuda"):
        return None
    return host_ms(stored(ctx), name, root)
