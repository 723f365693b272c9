"""The traced run's device profile: busy time, kernel time by name, and the
idle gaps labelled with what the host was doing.

``torch.profiler`` (CUPTI) records every operation the card ran and the
host-side spans: the port's aten ops and CUDA runtime calls, and the
benchmark's own ``pb.*`` spans (``record_function``) around its calls into
the port. The raw events are read straight from the profiler's results,
without building its per-event Python objects, which at a window's size
would take longer than the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "pb.window"


def span(name: str, on: bool):
    """A host span named ``name`` in the trace, or nothing when untraced."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # the traced window (the pb.window span)
    busy_s: float  # union of every device operation's interval in the window
    kernel_busy_s: float  # the same over kernels only (no copies or fills)
    device_ops: list  # [[kernel name, seconds]] most time first, at most 10
    idle_gaps: list  # [[host activity, seconds]] most idle time first, at most 10


def _union(intervals: np.ndarray) -> tuple[float, np.ndarray]:
    """Total length of the union of ``[start, end]`` rows, and the merged
    intervals."""
    if intervals.size == 0:
        return 0.0, intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            merged.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    merged.append((s, e))
    m = np.asarray(merged, dtype=np.float64)
    return float((m[:, 1] - m[:, 0]).sum()), m


def _label_gaps(mids: np.ndarray, host: list) -> list:
    """What the host thread was in at each gap's midpoint: its innermost
    open span, prefixed by the innermost benchmark span around it. ``host``
    is ``(start, end, name)`` of one thread, properly nested."""
    host = sorted(host, key=lambda r: (r[0], -r[1]))
    order = np.argsort(mids)
    labels = [""] * mids.size
    stack: list = []
    gi = 0

    def label(m):
        while stack and stack[-1][1] < m:
            stack.pop()
        inner = stack[-1][2] if stack else "outside spans"
        pb = next((n for _, _, n in reversed(stack) if n.startswith("pb.") and n != WINDOW_SPAN), None)
        if inner == WINDOW_SPAN:
            return "pb.window (harness Python)"
        if pb is None or inner == pb:
            return inner
        return f"{pb} > {inner}"

    for s, e, name in host:
        while gi < order.size and mids[order[gi]] < s:
            labels[order[gi]] = label(mids[order[gi]])
            gi += 1
        while stack and stack[-1][1] <= s:
            stack.pop()
        stack.append((s, e, name))
    while gi < order.size:
        labels[order[gi]] = label(mids[order[gi]])
        gi += 1
    return labels


def summarize(prof) -> TraceSummary | None:
    """Reduce a finished ``torch.profiler.profile`` to the summary; None when
    the trace holds no window span."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    host, dev = [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():  # a span's shadow on the device timeline
                dev.append((s, end, e.name()))
        elif e.device_type() == DeviceType.CPU:
            name = e.name()
            if name == WINDOW_SPAN:
                window = (s, end, e.start_thread_id())
            host.append((s, end, name, e.start_thread_id()))
    if window is None:
        return None
    w0, w1, tid = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    iv = np.asarray([(s, e) for s, e, _ in dev], dtype=np.float64).reshape(-1, 2)
    busy, merged = _union(iv)
    kern = np.asarray([(s, e) for s, e, n in dev if not n.startswith(("Memcpy", "Memset"))],
                      dtype=np.float64).reshape(-1, 2)
    kernel_busy, _ = _union(kern)
    by_name: dict = defaultdict(float)
    for s, e, n in dev:
        by_name[n[:160]] += (e - s) * 1e-9
    device_ops = sorted(([n, t] for n, t in by_name.items()), key=lambda r: -r[1])[:10]

    bounds = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = bounds[bounds[:, 1] > bounds[:, 0]]
    idle_gaps = []
    if gaps.size:
        thread = [(s, e, n) for s, e, n, t in host if t == tid and e > w0 and s < w1]
        labels = _label_gaps((gaps[:, 0] + gaps[:, 1]) / 2, thread)
        by_label: dict = defaultdict(float)
        for (a, b), lab in zip(gaps, labels):
            by_label[lab[:160]] += (b - a) * 1e-9
        idle_gaps = sorted(([n, t] for n, t in by_label.items()), key=lambda r: -r[1])[:10]
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                        kernel_busy_s=kernel_busy * 1e-9, device_ops=device_ops,
                        idle_gaps=idle_gaps)


class Profile:
    """``with Profile(on) as p:`` profiles the block when ``on``; then
    ``p.summary`` holds the reduction (None when untraced)."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: TraceSummary | None = None
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            import torch

            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self._prof)
            self._prof = None
        return False
