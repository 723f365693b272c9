"""Program spans: the serving stack's phases, timed on the host while a
``torch.profiler`` records.

A span names one phase of one flush or batch: the admission queue's flush,
the server's bucketize and sync, SAAT's plan, gather, tile sort and fused
kernel, DAAT's three phases. A kept :class:`Span` holds its name, its host
start and end (``time.perf_counter_ns``), the index of the span it ran
inside (its parent), the index of its flush or batch (``group``) and a few
small attributes. ``queue.flush`` carries its ``FlushRecord``'s index in
``AdmissionQueue.flush_log`` and its children inherit it, so a request's
chain runs ``Completion.rid`` -> the record whose ``rids`` hold it -> the
spans of that group. A root span that is given no group (a batch served
outside the queue) takes the number of such roots kept before it.

A step that repeats many times inside a span, such as the host read before
each pass of DAAT's phase-2 loop, is a :func:`tally`: no span of its own,
only a count and a host time summed on the span around it.

Tracing is on while a ``torch.profiler`` records in the process. Off, a
site costs one test and returns a shared do-nothing context: no record, no
allocation. On, each span is also opened as a profiler range of the same
name, so it sits in the profiler's timeline beside the kernels it
launched. No span adds a sync or a host read. Records are kept in memory
from when tracing turns on until :func:`take` hands them over; nothing is
exported.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _profiler

# a profiler range: the C++ one where this torch has it (about a tenth of
# record_function's host time; the profiler keeps it as a CPU op, so it
# casts no shadow on the device timeline)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _profiler.record_function
_lock = threading.Lock()
_local = threading.local()  # each thread's open spans
_kept: list = []
_roots = 0  # group-less root spans kept since the last take()


_OFF = contextlib.nullcontext()  # every site's span while tracing is off


class Span:
    """One kept span. ``parent`` is the index in :func:`take`'s list of the
    span it ran inside (-1 for a root)."""

    __slots__ = ("name", "index", "parent", "group", "attrs", "start_ns", "end_ns", "_range")

    def __init__(self, name: str, group: Optional[int], attrs: dict):
        self.name = name
        self.group = group
        self.attrs = attrs
        self.parent = -1
        self.index = -1
        self.start_ns = self.end_ns = None
        self._range = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self):
        return (f"Span({self.name!r}, index={self.index}, parent={self.parent}, "
                f"group={self.group}, start_ns={self.start_ns}, end_ns={self.end_ns}, "
                f"{self.attrs})")

    def __enter__(self):
        global _roots
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        with _lock:
            if self.group is None:
                if up is not None:
                    self.group = up.group
                else:
                    self.group = _roots
                    _roots += 1
            self.index = len(_kept)
            _kept.append(self)
        self.parent = -1 if up is None else up.index
        stack.append(self)
        self._range = _RANGE(self.name)
        self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _local.stack.pop()
        return False


class _Tally:
    __slots__ = ("attrs", "count", "total", "start_ns")

    def __init__(self, attrs: dict, name: str):
        self.attrs = attrs
        self.count, self.total = name + "s", name + "_ns"

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.start_ns
        a = self.attrs
        a[self.count] = a.get(self.count, 0) + 1
        a[self.total] = a.get(self.total, 0) + ns
        return False


def span(name: str, *, group: Optional[int] = None, bucket: Optional[int] = None,
         shape: Optional[int] = None, reason: Optional[str] = None,
         rho: Optional[int] = None, trip_cap: Optional[int] = None):
    """``with span(name, ...):`` around one phase. ``group``: the flush
    index (children inherit their parent's); the rest are the span's
    attributes, kept where given."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    attrs = {k: v for k, v in (("bucket", bucket), ("shape", shape), ("reason", reason),
                               ("rho", rho), ("trip_cap", trip_cap)) if v is not None}
    return Span(name, group, attrs)


def tally(name: str):
    """``with tally(name):`` around a step that repeats inside the innermost
    open span: that span's attributes count the steps (``<name>s``) and sum
    their host time (``<name>_ns``). No span or profiler range of its own."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    stack = getattr(_local, "stack", None)
    return _Tally(stack[-1].attrs, name) if stack else _OFF


def take() -> list:
    """Hand over the kept spans, in the order they opened (a span's
    ``index`` is its place in the list), and start a new list. Call it after
    the traced work: a span still open has no ``end_ns`` yet."""
    global _kept, _roots
    with _lock:
        out, _kept, _roots = _kept, [], 0
    return out
