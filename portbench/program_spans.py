"""The program's own spans of a traced window, for the per-layer metrics
that read them.

The port's recorder (``repro_torch.metrics.spans``) keeps a span while a
``torch.profiler`` records, so in a run it keeps the traced window's and
nothing else: the warm-up, the DAAT probe and the reference check run
untraced. The first reader takes them after the window and leaves them in
``run.records``. An untraced run, or a program without the recorder, gives
None, and each metric that reads spans then prints nothing.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np


def kept(run) -> list | None:
    """The window's spans, in the order they opened, or None."""
    if not run.trace:
        return None
    if "program_spans" not in run.records:
        try:
            from repro_torch.metrics import spans
        except ImportError:  # a program that keeps no spans
            run.records["program_spans"] = None
        else:
            run.records["program_spans"] = [s for s in spans.take() if s.end_ns is not None] or None
    return run.records["program_spans"]


def named(run, name: str) -> list | None:
    """The window's spans called ``name``; None where it kept none."""
    found = [s for s in kept(run) or () if s.name == name]
    return found or None


def host_ms(run, name: str) -> np.ndarray | None:
    found = named(run, name)
    return None if found is None else np.asarray([s.host_ms for s in found])


def children_ms(run, parent: str, child: str) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """For each span called ``parent``: its host ms, its ``child``
    children's host ms summed, and how many children it had."""
    spans = kept(run)
    parents = named(run, parent)
    if parents is None:
        return None
    total: dict = defaultdict(float)
    count: dict = defaultdict(int)
    for s in spans:
        if s.name == child and s.parent >= 0:
            total[s.parent] += s.host_ms
            count[s.parent] += 1
    return (np.asarray([p.host_ms for p in parents]),
            np.asarray([total[p.index] for p in parents]),
            np.asarray([count[p.index] for p in parents]))


def host_ms_per_group(run, names: tuple) -> np.ndarray | None:
    """Host ms of the spans called one of ``names``, summed over each flush
    or batch (the spans' ``group``) that ran any of them."""
    by_group: dict = defaultdict(float)
    for s in kept(run) or ():
        if s.name in names:
            by_group[s.group] += s.host_ms
    return np.asarray(list(by_group.values())) if by_group else None


def phase2(run) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """For each batch's ``daat.phase2`` span: its host ms, the host ms of
    its host reads (the ``read`` tally) and how many reads it made."""
    found = named(run, "daat.phase2")
    if found is None:
        return None
    return (np.asarray([s.host_ms for s in found]),
            np.asarray([s.attrs.get("read_ns", 0) * 1e-6 for s in found]),
            np.asarray([s.attrs.get("reads", 0) for s in found]))
