"""Index lifecycle management over the serving stack: when to compact, and
how a hot swap interleaves with live traffic.

The port of ``repro.serving.lifecycle``, policy for policy.

The mutable-corpus machinery lives in :class:`repro_torch.core.index_handle.
IndexHandle` (delta segment, tombstones, :meth:`~repro_torch.core.index_handle.
IndexHandle.compact`); the serving layers know how to *adopt* a new
generation (:meth:`AnytimeServer.swap_index` / :meth:`AdmissionQueue.
swap_index` — calibration decayed, never discarded). This module supplies
the policy between them:

  * :class:`CompactionPolicy` / :class:`Compactor` — the threshold rule for
    when accumulated churn justifies folding main + delta − tombstones into
    a fresh main segment, and the driver that runs the fold off the serving
    path and hot-swaps the result in. Two pressures trigger it: a fat delta
    (every dispatch pays the delta scan + merge) and a tombstone-heavy main
    (budgeted work wasted scoring docs that are masked to ``-inf`` at
    select time).
  * :func:`replay_with_churn` — the deterministic mutation-replay harness:
    one simulated-clock event loop that interleaves query arrivals, index
    mutations, due-time flushes, and threshold compactions. Mutations and
    compactions only ever run *between* flushes (the event loop applies them
    at their timestamps, and flushes are synchronous), which is precisely
    the hot-swap contract: no request observes a half-swapped index, and a
    swap loses / duplicates / reorders zero requests. The mutation log the
    replay returns records the generation at every event, so tests can pin
    ``FlushRecord.generation`` monotonicity against it.

Compaction here is "background" in the scheduling sense, not the threading
sense: on the simulated clock it is a synchronous step whose wall time the
caller can model by advancing the clock. That keeps the replay a pure
function of its event schedule — the property every serving test in this
repo is built on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.index_handle import IndexHandle
from repro_torch.metrics.latency import SimulatedClock
from repro_torch.serving.queue import AdmissionQueue, Completion


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Threshold rule: fold the LSM triple once churn makes serving pay.

    ``max_delta_docs``: delta segment size at which the per-dispatch delta
    scan + merge overhead justifies a rebuild. ``max_tombstone_frac``:
    fraction of the MAIN segment's docs that are tombstoned — dead docs
    still occupy blocks, so the budgeted scan wastes rho/block budget on
    rows the live mask immediately demotes to ``-inf``. ``min_tombstones``
    keeps a tiny corpus from compacting on its first delete.
    """

    max_delta_docs: int = 128
    max_tombstone_frac: float = 0.25
    min_tombstones: int = 8

    def due(self, handle: IndexHandle) -> bool:
        if handle.delta_docs >= self.max_delta_docs:
            return True
        # only tombstones that still OCCUPY postings in main create scan
        # waste; a gid dead since before the last compaction already has an
        # empty row (ids are never re-used), so counting it would latch the
        # trigger permanently after the first tombstone-driven fold
        doc_n_terms = handle.main.doc_n_terms.cpu().numpy()
        dead_in_main = sum(
            1
            for g in handle.dead_gids
            if g < handle.main.n_docs and doc_n_terms[g] > 0
        )
        if dead_in_main < self.min_tombstones:
            return False
        return dead_in_main >= self.max_tombstone_frac * max(handle.main.n_docs, 1)


class Compactor:
    """Threshold-driven compaction driver over one queue (or bare server).

    ``maybe_compact()`` checks the policy, and when due: folds the handle
    (:meth:`IndexHandle.compact`) and hot-swaps the serving stack
    (:meth:`AdmissionQueue.swap_index` — or the server's, when no queue is
    involved). Call it between flushes — e.g. from the event loop of
    :func:`replay_with_churn`, or after ``poll()`` in a driver.
    """

    def __init__(
        self,
        target,  # AdmissionQueue | AnytimeServer
        handle: IndexHandle,
        policy: CompactionPolicy = CompactionPolicy(),
        *,
        decay: float = 0.5,
    ):
        self.target = target
        self.handle = handle
        self.policy = policy
        self.decay = decay
        self.n_compactions = 0
        self.log: list[dict] = []

    def maybe_compact(self, now_s: Optional[float] = None) -> bool:
        if not self.policy.due(self.handle):
            return False
        before = dict(
            delta_docs=self.handle.delta_docs,
            tombstones=self.handle.tombstone_count,
            n_docs_main=self.handle.main.n_docs,
        )
        self.handle.compact()
        self.target.swap_index(decay=self.decay)
        self.n_compactions += 1
        self.log.append(
            dict(
                t_s=now_s,
                generation=self.handle.generation,
                **before,
            )
        )
        return True


@dataclasses.dataclass(frozen=True)
class MutationEvent:
    """One corpus mutation at an instant of the replay's simulated clock.

    ``op`` is ``"add"`` | ``"update"`` | ``"delete"``; ``gid`` identifies the
    target for update/delete (``None`` for add — the handle assigns the next
    gid); ``terms``/``weights`` carry the sparse vector for add/update.
    """

    t_s: float
    op: str
    gid: Optional[int] = None
    terms: Optional[np.ndarray] = None
    weights: Optional[np.ndarray] = None


def _apply_mutation(handle: IndexHandle, ev: MutationEvent) -> Optional[int]:
    if ev.op == "add":
        return handle.add(ev.terms, ev.weights)
    if ev.op == "update":
        handle.update(ev.gid, ev.terms, ev.weights)
        return ev.gid
    if ev.op == "delete":
        handle.delete(ev.gid)
        return ev.gid
    raise ValueError(f"unknown mutation op {ev.op!r}")


def replay_with_churn(
    queue: AdmissionQueue,
    handle: IndexHandle,
    arrivals_s: Sequence[float],
    q_terms_list: Sequence[np.ndarray],
    q_weights_list: Sequence[np.ndarray],
    deadlines_ms: Sequence[float],
    mutations: Sequence[MutationEvent],
    *,
    compactor: Optional[Compactor] = None,
) -> tuple[list[Completion], list[dict]]:
    """Deterministically replay queries AND corpus churn on one clock.

    Extends :func:`repro_torch.serving.queue.replay_arrivals` with a third event
    stream: at each step the loop advances the queue's
    :class:`~repro_torch.metrics.latency.SimulatedClock` to the earliest of (next
    arrival, next mutation, ``next_due()``) and handles exactly that event.
    Mutations apply to the handle at their timestamps; after each one the
    optional ``compactor`` gets a chance to fold and hot-swap. Because every
    flush is synchronous inside ``poll()``/``submit()``, mutations and swaps
    can only ever land *between* flushes — the replay is the executable
    statement of the hot-swap contract.

    Returns ``(completions, mutation_log)``; each mutation-log entry records
    the op, the gid it touched, the clock instant, the handle's generation
    AFTER the op (and any compaction it triggered), and the live
    delta/tombstone tallies — enough for a test to reconstruct the exact
    corpus any completed request was served against.
    """
    clock = queue.clock
    if not isinstance(clock, SimulatedClock):
        raise TypeError(
            "replay_with_churn drives time itself; queue needs a SimulatedClock"
        )
    if not (
        len(arrivals_s) == len(q_terms_list) == len(q_weights_list) == len(deadlines_ms)
    ):
        raise ValueError("arrival schedule fields must have equal length")
    muts = sorted(mutations, key=lambda ev: ev.t_s)
    inf = float("inf")
    completions: list[Completion] = []
    mutation_log: list[dict] = []
    i, n = 0, len(arrivals_s)
    j, m = 0, len(muts)
    while i < n or j < m or queue.pending():
        t_arr = arrivals_s[i] if i < n else inf
        t_mut = muts[j].t_s if j < m else inf
        due = queue.next_due()
        t_due = due if due is not None else inf
        t_next = min(t_arr, t_mut, t_due)
        if t_next is inf:
            break
        clock.advance_to(t_next)
        # mutations first at a tie: a query arriving at the same instant as a
        # write observes the write (read-your-writes at equal timestamps)
        if t_mut <= min(t_arr, t_due):
            ev = muts[j]
            j += 1
            gid = _apply_mutation(handle, ev)
            compacted = bool(compactor and compactor.maybe_compact(now_s=t_next))
            mutation_log.append(
                dict(
                    t_s=t_next, op=ev.op, gid=gid,
                    generation=handle.generation,
                    delta_docs=handle.delta_docs,
                    tombstones=handle.tombstone_count,
                    compacted=compacted,
                )
            )
        elif t_arr <= t_due:
            queue.submit(q_terms_list[i], q_weights_list[i], deadlines_ms[i])
            i += 1
        completions.extend(queue.poll())
    completions.extend(queue.drain())
    return completions, mutation_log
