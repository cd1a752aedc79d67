"""Spans of the port's own layers, on the profiler's clock.

A span marks one call of a layer: ``with telemetry.span("train/step"):``.
Tracing is on while a ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``) and off otherwise.

Off, ``span`` checks that one flag and returns a shared null context: it
opens no profiler range and stores nothing, so a span costs a function call
and a flag check.

On, ``span`` opens ``torch.profiler.record_function(name)``, so the span is
a user annotation of the profiler's trace and the device operations
launched inside it are tied to it by their launches. It also keeps a
``Span`` record in a bounded in-memory store:

- ``start_ns`` and ``end_ns`` from ``time.time_ns()``: Unix-epoch
  nanoseconds, the clock of the profiler's CPU events, so a record and its
  annotation agree;
- ``parent``: the id of the span open around it on its thread. A span that
  opens on a thread with no span open, while a root is open on another
  thread, takes as parent the innermost span open on the root's thread: the
  autograd engine runs a CUDA backward on a device thread of its own, and a
  span opened there during a step belongs to that step;
- ``root``: the id of the outermost span of the call it belongs to (its own
  id for a root);
- ``attrs``: the keyword arguments given to ``span`` (shapes), kept only
  when on.

``spans()`` returns the store's records in the order they closed,
``clear()`` empties it and ``dropped()`` counts the records that found it
full (``LIMIT``). Nothing is exported: the profiler writes the timeline.

The spans the port opens, each named after its layer:

  ``train/step``             a whole ``train_step`` (a root)
  ``train/global_norm``      the gradients' global norm, where the step
                             waits for the card
  ``train/optimizer``        an optimizer's ``update`` (AdamW, Adafactor)
  ``serve/prefill``          a whole prefill step (a root)
  ``kernels/ssd.chunk_fwd``  the SSD chunk step's forward (attrs ``x``: x's
                             shape, ``n``: the state size, ``chunk``)
  ``kernels/ssd.chunk_bwd``  its backward (the plain recompute)
  ``kernels/ssd.scan``       ``ssd_chunks``' inter-chunk recurrence and
                             off-diagonal term (attrs ``chunks``)
  ``kernels/flash_attention.bwd``  attention's plain backward
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

LIMIT = 1 << 16  # records the store keeps

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
_roots: list = []  # (root Span, its thread's stack of open spans), the newest last
_store: list = []
_dropped = 0


@dataclasses.dataclass(slots=True)
class Span:
    """One span's record (the module's docstring says what each field holds)."""

    id: int
    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    root: int
    attrs: dict


class _Recording:
    """The context of one span while tracing is on."""

    __slots__ = ("name", "attrs", "span", "stack", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        sid = next(_ids)
        with _lock:
            if stack:
                parent, root = stack[-1].id, stack[-1].root
            elif _roots:
                root_span, root_stack = _roots[-1]
                parent, root = root_stack[-1].id, root_span.id
            else:
                parent, root = None, sid
            s = Span(sid, self.name, 0, None, parent, root, self.attrs)
            if root == sid:
                _roots.append((s, stack))
            stack.append(s)
        self.span, self.stack = s, stack
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        s.start_ns = time.time_ns()
        return s

    def __exit__(self, *exc):
        global _dropped
        s = self.span
        s.end_ns = time.time_ns()
        self.range.__exit__(*exc)
        with _lock:
            self.stack.pop()
            if s.root == s.id:
                _roots[:] = [r for r in _roots if r[0] is not s]
            if len(_store) < LIMIT:
                _store.append(s)
            else:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A context for one call of the layer ``name``: a profiler range and a
    stored ``Span`` while a profiler records, the shared null context
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Recording(name, attrs)


def spans() -> list:
    """The stored spans, in the order they closed."""
    with _lock:
        return list(_store)


def dropped() -> int:
    """Spans that closed while the store was full."""
    return _dropped


def clear():
    """Empties the store and its count of dropped spans."""
    global _dropped
    with _lock:
        _store.clear()
        _dropped = 0
