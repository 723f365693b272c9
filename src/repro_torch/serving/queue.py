"""Continuous-batching admission queue over the anytime server.

The port of ``repro.serving.queue``: the policy is the reference's, line
for line; a flush's results come back to the host with ``.cpu()`` (one
device-to-host copy per flush, after the server has synchronised).

The paper's latency story is about *arrival-driven* traffic: SAAT's rho
budget makes per-query cost predictable while DAAT's tail is data-dependent.
``run_query_stream`` serves fixed pre-formed batches, which never exercises
that story. This module adds the missing serving front end: an
:class:`AdmissionQueue` accepts ``(q_terms, q_weights, deadline)`` requests
one at a time, coalesces them into the calibrated ``(B, Lq-bucket)``
grid of batch shapes of an :class:`~repro_torch.serving.scheduler.AnytimeServer`, and
flushes a batch when it fills — or when waiting any longer would make the
oldest request miss its deadline given the cost model's predicted service
time.

Coalescing policy
-----------------
  * Requests are partitioned by **Lq bucket** (``repro_torch.serving.bucketing``):
    a short query never pays a long query's gather cost, and every flush
    lands on a calibrated ``(B, bucket)`` shape (pad-to-shape is free by
    construction — trailing pad slots are bit-identity-preserving).
  * Within a bucket, admission order is FIFO. For the SAAT engine, flush
    order equals admission order. For the **DAAT engine**, the batch drawn
    from the FIFO prefix is re-ordered by *predicted survivor count*
    (:class:`SurvivorPredictor`, an EMA over observed ``WorkStats`` history):
    the batched phase-2 loop runs until the slowest query is rank-safe, so
    co-scheduling requests with similar predicted work trims the batch tail.
    Completions may therefore permute *within one flush* — never across
    flushes. This is the "reordered-beyond-policy" boundary the tests pin.
  * A flush uses the smallest allowed batch shape that covers the pending
    prefix; missing rows are *inert sentinel rows* (all pad term ids, zero
    weights). A sentinel row has no survivors and idles after the first
    trip, so a short DAAT flush never burns loop work re-scoring a
    duplicated request; real-row results are independent of pad rows in
    both engines, and only the ``n_real`` real rows ever reach the
    ``SurvivorPredictor`` or the shape-keyed service-time EMA's per-request
    accounting.

Flush-time policy
-----------------
A bucket is *due* at ``oldest.deadline - predicted_service(B, bucket) -
safety`` — or at ``oldest.arrival + max_wait_s`` if that comes first: the
age bound is what keeps best-effort traffic (``deadline_ms=None``) from
starving in a bucket that never fills. ``poll()`` flushes every due bucket;
``next_due()`` exposes the
earliest such instant so a driver (or a simulated-clock test harness) can
sleep exactly until the next decision point instead of busy-polling. A
flush that happens later than its due instant is recorded as a policy
violation in ``flush_log`` — the serving suite asserts there are none.

``degrade_rho=True`` (SAAT only) arms the anytime knob the paper's serving
argument turns on: when a lane's due instant arrives before it fills, the
flush serves at the **largest calibrated rho whose predicted service still
meets the oldest deadline** (``AnytimeServer.pick_degraded_rho``) instead of
blowing the deadline at the full budget. The rho actually served is recorded
on every ``FlushRecord`` and ``Completion``, and the violation judgement
uses the served level's predicted service — degradation *replaces*
violation, and the effectiveness cost of each degraded flush is auditable
against the rho ladder (see ``repro_torch.metrics.ir_metrics``).

The ``Clock`` injection point
-----------------------------
All time in this subsystem flows through one injectable
:class:`repro_torch.metrics.latency.Clock`: the queue's arrival stamps, deadline
arithmetic, and due-time computation, *and* the server's latency/cost-model
measurements (the server shares the same clock instance by default). Pass a
:class:`repro_torch.metrics.latency.SimulatedClock` and the whole admission →
coalesce → flush → complete pipeline becomes a deterministic function of
the arrival schedule: tests advance time explicitly (``clock.advance_to``)
between ``submit``/``poll`` calls and can replay hundreds of Poisson
arrivals with zero flakiness. Production constructs the queue with the
default :class:`~repro_torch.metrics.latency.SystemClock`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence

import numpy as np

from repro_torch.metrics import spans
from repro_torch.metrics.latency import Clock, SimulatedClock, SystemClock  # noqa: F401  (re-export)
from repro_torch.serving.bucketing import (
    bucket_for,
    effective_lq,
    normalize_buckets,
    pad_to_width,
    sentinel_rows,
)
from repro_torch.serving.counters import CounterRegistry
from repro_torch.serving.scheduler import AnytimeServer

_EPS_S = 1e-9  # float tolerance when judging "flushed after its due instant"


class SurvivorPredictor:
    """EMA of observed DAAT survivor counts, keyed by effective query length.

    ``WorkStats.n_survivors`` is the paper's per-query work metric: the
    number of blocks that outlive phase-1 pruning, which is what the batched
    phase-2 trip count — and therefore the batch tail — tracks. Queries
    with the same effective Lq tend to have similar survivor counts, so the
    EMA is keyed by ``lq_eff``; an unseen key falls back to the *nearest
    observed* Lq key first (survivor counts are roughly monotone in Lq, so a
    neighbor is informative where a global mean over a bimodal stream is
    not), and to the global EMA only before any observation at all.
    """

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._by_lq: dict[int, float] = {}
        self._global: Optional[float] = None
        # per-key trust in [0, 1]: 1.0 is the steady state (observe smooths
        # at exactly alpha). A hot swap decays trust instead of discarding
        # the EMA — survivor counts over the compacted corpus are close to
        # the pre-swap ones (the live docs are the same), so the old value
        # is the right prior, it just re-converges faster.
        self._conf: dict[int, float] = {}
        self._gconf: float = 1.0

    def observe(self, lq_eff: int, survivors: float):
        s = float(survivors)
        a = self.alpha
        conf = self._conf.get(lq_eff, 1.0)
        a_eff = a + (1 - a) * (1 - conf)
        old = self._by_lq.get(lq_eff)
        self._by_lq[lq_eff] = s if old is None else (1 - a_eff) * old + a_eff * s
        self._conf[lq_eff] = 1 - (1 - conf) * (1 - a)
        g_eff = a + (1 - a) * (1 - self._gconf)
        self._global = s if self._global is None else (1 - g_eff) * self._global + g_eff * s
        self._gconf = 1 - (1 - self._gconf) * (1 - a)

    def decay(self, factor: float = 0.5):
        """Generation bump: keep every EMA value, shrink its trust."""
        for key in self._by_lq:
            self._conf[key] = self._conf.get(key, 1.0) * factor
        self._gconf *= factor

    def predict(self, lq_eff: int) -> float:
        v = self._by_lq.get(lq_eff)
        if v is not None:
            return v
        # unseen Lq: the nearest observed key beats the global EMA. Under a
        # bimodal stream (say Lq 3 and 30) the global mean describes NO
        # query, so predicting with it interleaved short and long queries in
        # one batch — exactly the tail the survivor sort exists to avoid.
        # Ties break toward the smaller key (stable, deterministic).
        if self._by_lq:
            nearest = min(self._by_lq, key=lambda key: (abs(key - lq_eff), key))
            return self._by_lq[nearest]
        return self._global if self._global is not None else 0.0


@dataclasses.dataclass
class _Request:
    rid: int
    q_terms: np.ndarray  # [lq_eff] trimmed to live width
    q_weights: np.ndarray
    arrival_s: float
    deadline_s: float  # absolute, clock domain
    lq_eff: int
    bucket: int


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    scores: np.ndarray  # f32[k]
    doc_ids: np.ndarray  # i32[k]
    arrival_s: float
    flush_s: float
    deadline_s: float
    bucket: int
    batch_shape: int
    rho: Optional[int]  # ladder level actually served; None for the daat engine

    @property
    def wait_ms(self) -> float:
        return (self.flush_s - self.arrival_s) * 1e3


@dataclasses.dataclass(frozen=True)
class FlushRecord:
    flush_s: float
    bucket: int
    batch_shape: int
    n_real: int
    rids: tuple[int, ...]
    rho: Optional[int]
    predicted_ms: float
    oldest_deadline_s: float
    reason: str  # "full" | "deadline" | "drain"
    # flushed too late for the predicted service to finish by the oldest
    # deadline (safety_ms is headroom BEFORE this boundary, not part of it:
    # a flush inside its safety margin is early, not violating)
    violation: bool
    # the oldest request's deadline was unmeetable the moment it ARRIVED
    # (deadline - predicted service < arrival): the queue flushes best-effort
    # immediately, and the miss is admission infeasibility, not a scheduling
    # failure — counted separately from `violation`
    infeasible: bool
    # index lifecycle generation the flush was served at (0 for an immutable
    # server). Monotone non-decreasing across flush_log: swaps happen only
    # between flushes, never under one — the hot-swap tests pin this.
    generation: int = 0


class AdmissionQueue:
    """Deadline-aware request coalescing onto the (B, Lq-bucket) grid.

    Parameters
    ----------
    server: the engine + grid of batch shapes; its ``lq_buckets`` (or ``max_lq``)
        define the width grid, ``batch_shapes`` the allowed B values.
    batch_shapes: allowed flush batch sizes, ascending. A bucket flushes as
        "full" at the largest shape; a deadline flush uses the smallest
        shape covering the pending prefix.
    clock: defaults to the *server's* clock so queue wait and service cost
        share one time domain.
    safety_ms: subtracted from every due instant (headroom for dispatch
        overhead the cost model cannot see).
    max_wait_s: age-based flush trigger — a bucket is due no later than
        ``oldest.arrival + max_wait_s`` even when no deadline says so.
        Without it, a non-full bucket whose pending requests all carry no
        (or an infinite) deadline is never due: ``next_due()`` has nothing
        to report and the requests starve until ``drain()``. ``None``
        (default) keeps the pure deadline-driven policy.
    dynamic_rho: when True (SAAT only), each flush re-picks rho against the
        oldest request's *remaining* budget instead of the server default.
    degrade_rho: when True (SAAT only), a flush that can no longer meet the
        oldest deadline at the default budget degrades to the largest
        *calibrated* ladder level whose predicted service for this exact
        ``(batch shape, bucket)`` still fits the remaining time
        (``AnytimeServer.pick_degraded_rho``); the served level is recorded
        in ``flush_log``/completions and the violation judgement uses it.
        Differs from ``dynamic_rho`` in consulting the shape-keyed
        service-time EMA (whole-flush wall time) rather than the per-query
        rho cost model; the two policies are mutually exclusive.
    """

    def __init__(
        self,
        server: AnytimeServer,
        *,
        batch_shapes: Sequence[int] = (8, 32),
        clock: Optional[Clock] = None,
        safety_ms: float = 0.0,
        max_wait_s: Optional[float] = None,
        dynamic_rho: bool = False,
        degrade_rho: bool = False,
        max_lq: Optional[int] = None,
        survivor_alpha: float = 0.2,
    ):
        self.server = server
        self.clock: Clock = clock if clock is not None else server.clock
        self.batch_shapes = tuple(sorted(set(int(b) for b in batch_shapes)))
        if not self.batch_shapes or self.batch_shapes[0] <= 0:
            raise ValueError(f"batch_shapes must be positive, got {batch_shapes!r}")
        if server.lq_buckets is not None:
            self.buckets = server.lq_buckets
        elif max_lq is not None:
            self.buckets = normalize_buckets((max_lq,))
        else:
            raise ValueError(
                "server has no lq_buckets; pass max_lq= so the queue has a width grid"
            )
        self.safety_s = safety_ms / 1e3
        if max_wait_s is not None and max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self.max_wait_s = max_wait_s
        if (dynamic_rho or degrade_rho) and server.cfg.engine != "saat":
            raise ValueError(
                "dynamic_rho/degrade_rho trade the SAAT posting budget; the "
                "daat engine has no rho knob"
            )
        if dynamic_rho and degrade_rho:
            raise ValueError(
                "dynamic_rho and degrade_rho are alternative flush-time rho "
                "policies; enable at most one"
            )
        self.dynamic_rho = dynamic_rho
        self.degrade_rho = degrade_rho
        self.survivors = SurvivorPredictor(alpha=survivor_alpha)
        self._pending: dict[int, deque[_Request]] = {b: deque() for b in self.buckets}
        self._completions: list[Completion] = []
        self._next_rid = 0
        self.flush_log: list[FlushRecord] = []
        self.n_submitted = 0
        self.n_completed = 0

    # ------------------------------ admission ------------------------------

    def submit(self, q_terms, q_weights, deadline_ms: Optional[float] = None) -> int:
        """Admit one request; returns its rid. May flush a now-full bucket.

        ``deadline_ms=None`` (or ``inf``) admits a best-effort request with
        no latency contract: it never makes its bucket due on its own, so it
        flushes when the bucket fills, when a deadlined neighbor is due, or
        at the ``max_wait_s`` age bound.
        """
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
        qt = np.asarray(q_terms, dtype=np.int32).reshape(-1)
        qw = np.asarray(q_weights, dtype=np.float32).reshape(-1)
        if qt.shape != qw.shape:
            raise ValueError(f"terms/weights shape mismatch: {qt.shape} vs {qw.shape}")
        n_terms = self.server.index.n_terms
        eff = effective_lq(qt[None, :], qw[None, :], n_terms)
        bucket = bucket_for(eff, self.buckets)
        if bucket not in self._pending:  # overflow width: own lane, calibrated on demand
            self._pending[bucket] = deque()
        now = self.clock.now()
        rid = self._next_rid
        self._next_rid += 1
        self.n_submitted += 1
        self._pending[bucket].append(
            _Request(
                rid=rid,
                q_terms=qt[:eff].copy(),
                q_weights=qw[:eff].copy(),
                arrival_s=now,
                deadline_s=(
                    float("inf") if deadline_ms is None else now + deadline_ms / 1e3
                ),
                lq_eff=eff,
                bucket=bucket,
            )
        )
        while len(self._pending[bucket]) >= self.batch_shapes[-1]:
            self._flush(bucket, reason="full")
        return rid

    def pending(self) -> int:
        return sum(len(q) for q in self._pending.values())

    # --------------------------- index lifecycle ---------------------------

    def swap_index(self, handle=None, *, decay: float = 0.5):
        """Hot-swap the serving index between flushes; pending requests ride.

        Delegates to :meth:`AnytimeServer.swap_index` (rebind main-segment
        statics, bump generation, decay — never discard — the service-time
        calibration) and applies the same decay to the survivor predictor.
        Pending requests are host-side rows keyed by Lq bucket, a grid the
        swap cannot change (the vocabulary is fixed for the handle's
        lifetime), so a swap loses, duplicates, and reorders **zero**
        requests: everything admitted before the swap flushes after it,
        against the new generation — the invariant the hot-swap replay tests
        pin via ``FlushRecord.generation`` monotonicity + rid accounting.
        """
        self.server.swap_index(handle, decay=decay)
        self.survivors.decay(decay)

    # ----------------------------- flush policy ----------------------------

    def _shape_for(self, n: int) -> int:
        for b in self.batch_shapes:
            if b >= n:
                return b
        return self.batch_shapes[-1]

    def _due_instant(self, bucket: int) -> Optional[float]:
        q = self._pending[bucket]
        if not q:
            return None
        shape = self._shape_for(len(q))
        # an overfull lane (> largest shape) drains as ceil(n/shape) chunked
        # launches, and the lane's deadlines are only safe once the LAST
        # launch lands — predicting one launch made the due instant
        # optimistic exactly when the lane was overloaded
        launches = -(-len(q) // shape)
        predicted_ms = self.server.predict_service_ms(shape, bucket) * launches
        oldest = min(r.deadline_s for r in q)
        due = oldest - predicted_ms / 1e3 - self.safety_s
        # age bound: deadline-less (inf) requests would otherwise push `due`
        # to +inf and starve in a bucket that never fills
        if self.max_wait_s is not None:
            due = min(due, min(r.arrival_s for r in q) + self.max_wait_s)
        return due if due < float("inf") else None

    def next_due(self) -> Optional[float]:
        """Earliest instant at which some bucket must flush (None if empty)."""
        dues = [d for b in self._pending for d in [self._due_instant(b)] if d is not None]
        return min(dues) if dues else None

    def poll(self) -> list[Completion]:
        """Flush every due bucket, then hand back (and clear) completions."""
        for bucket in sorted(self._pending):
            while True:
                # Re-read the clock every iteration: under a real (or hybrid)
                # clock an earlier bucket's flush accrues service time, which
                # can make THIS bucket due *during* the same poll — judging
                # every bucket against the poll's entry time flushed it one
                # driver wakeup late.
                now = self.clock.now()
                due = self._due_instant(bucket)
                if due is None or now < due - _EPS_S:
                    break
                self._flush(bucket, reason="deadline")
        return self.take_completions()

    def drain(self) -> list[Completion]:
        """Flush everything pending regardless of deadlines (end of stream)."""
        for bucket in sorted(self._pending):
            while self._pending[bucket]:
                self._flush(bucket, reason="drain")
        return self.take_completions()

    def take_completions(self) -> list[Completion]:
        out = self._completions
        self._completions = []
        return out

    # ------------------------------- flushing ------------------------------

    def _flush(self, bucket: int, reason: str):
        """Serve the pending lane: one launch, or — when the lane holds more
        than the largest batch shape — every ceil(n/top) chunked launch it
        takes to drain it. One ``FlushRecord`` per launch; each launch reads
        the clock itself, so on a real clock a later chunk's violation
        judgement sees the service time the earlier chunks actually spent.
        """
        top = self.batch_shapes[-1]
        n_chunks = max(-(-len(self._pending[bucket]) // top), 1)
        for _ in range(n_chunks):
            self._flush_chunk(bucket, reason)

    def _flush_chunk(self, bucket: int, reason: str):
        q = self._pending[bucket]
        if not q:
            return
        n = min(len(q), self.batch_shapes[-1])
        shape = self._shape_for(n)
        # the flush's span carries the index its FlushRecord takes below
        with spans.span("queue.flush", group=len(self.flush_log), bucket=bucket, shape=shape,
                        reason=reason):
            now = self.clock.now()
            batch = [q.popleft() for _ in range(n)]
            daat = self.server.cfg.engine == "daat"
            if daat:
                # straggler-aware composition: similar predicted survivor counts
                # sit in one batch so the loop tail tracks the batch, not
                # the stream (stable sort: FIFO among equal predictions)
                batch.sort(key=lambda r: self.survivors.predict(r.lq_eff))
            # rows [n:] stay inert sentinels (all pad ids, zero weights): cheaper
            # than repeating the last request, which burned DAAT loop work
            # on a duplicate's survivors
            qt, qw = sentinel_rows(shape, bucket, self.server.index.n_terms)
            for i, r in enumerate(batch):
                t, w = pad_to_width(r.q_terms, r.q_weights, bucket, self.server.index.n_terms)
                qt[i], qw[i] = t, w
            r_oldest = min(batch, key=lambda r: r.deadline_s)
            oldest = r_oldest.deadline_s
            rho: Optional[int] = None
            if not daat:
                # pick the level here (identically to what search_batch would do)
                # so completions/flush_log record the budget actually served
                if self.degrade_rho:
                    # budget = time to the oldest deadline, less the same safety
                    # headroom the due instant reserves; the epsilon keeps an
                    # exactly-on-time flush from degrading over float round-off
                    remaining_ms = max((oldest - now - self.safety_s + _EPS_S) * 1e3, 0.0)
                    rho = self.server.pick_degraded_rho(shape, bucket, remaining_ms)
                elif self.dynamic_rho:
                    remaining_ms = max((oldest - now) * 1e3, 0.0)
                    rho = self.server.pick_rho(deadline_ms=remaining_ms)
                else:
                    rho = self.server.pick_rho()
            # predicted service of the level ACTUALLY served: the violation /
            # infeasibility judgement below must account degradation as meeting
            # the deadline it was chosen to meet, not as missing full-rho's
            predicted_ms = self.server.predict_service_ms(shape, bucket, rho=rho)
            res = self.server.search_batch(qt, qw, rho=rho)
            scores = res.scores.cpu().numpy()
            ids = res.doc_ids.cpu().numpy()
            stats = getattr(res, "stats", None) if daat else None
            if stats is not None:
                survivors = stats.n_survivors.cpu().numpy()
                for i, r in enumerate(batch):
                    self.survivors.observe(r.lq_eff, float(survivors[i]))
            for i, r in enumerate(batch):
                self._completions.append(
                    Completion(
                        rid=r.rid,
                        scores=scores[i],
                        doc_ids=ids[i],
                        arrival_s=r.arrival_s,
                        flush_s=now,
                        deadline_s=r.deadline_s,
                        bucket=bucket,
                        batch_shape=shape,
                        rho=rho,
                    )
                )
        self.n_completed += n
        due = oldest - predicted_ms / 1e3  # violation boundary excludes safety headroom
        infeasible = due <= r_oldest.arrival_s + _EPS_S  # unmeetable at admission
        self.flush_log.append(
            FlushRecord(
                flush_s=now,
                bucket=bucket,
                batch_shape=shape,
                n_real=n,
                rids=tuple(r.rid for r in batch),
                rho=rho,
                predicted_ms=predicted_ms,
                oldest_deadline_s=oldest,
                reason=reason,
                violation=bool(now > due + _EPS_S) and not infeasible and reason != "drain",
                infeasible=infeasible,
                generation=getattr(self.server, "generation", 0),
            )
        )

    # ------------------------------ reporting ------------------------------

    @property
    def n_violations(self) -> int:
        return sum(1 for f in self.flush_log if f.violation)

    @property
    def n_infeasible(self) -> int:
        return sum(1 for f in self.flush_log if f.infeasible)

    @property
    def n_degraded(self) -> int:
        """Flushes served below the full posting budget (SAAT only)."""
        if self.server.cfg.engine != "saat":
            return 0
        top = self.server.rho_ladder[-1]
        return sum(1 for f in self.flush_log if f.rho is not None and f.rho < top)

    def export_counters(
        self,
        registry: Optional[CounterRegistry] = None,
        labels: Optional[dict] = None,
    ) -> CounterRegistry:
        """Scrape-time counter export, derived wholly from records this queue
        already keeps (``flush_log``, admission tallies, pending lanes) — no
        hot-path instrumentation anywhere. ``labels`` (e.g. ``{"host": "2"}``)
        are attached to every sample so several queues can share a registry.
        """
        reg = registry if registry is not None else CounterRegistry()
        base = {str(k): str(v) for k, v in (labels or {}).items()}
        reg.counter("repro_queue_submitted_total", "Requests admitted").labels(**base).inc(
            self.n_submitted
        )
        reg.counter("repro_queue_completed_total", "Requests served").labels(**base).inc(
            self.n_completed
        )
        flushes = reg.counter(
            "repro_queue_flush_total", "Flushes by Lq bucket and trigger reason"
        )
        occupancy = reg.histogram(
            "repro_queue_flush_occupancy",
            "Real rows / batch shape per flush (executable fill factor)",
            buckets=(0.25, 0.5, 0.75, 1.0),
        )
        served_rho = reg.counter(
            "repro_queue_served_rho_total",
            "Flushes by served SAAT posting budget (daat flushes under rho=\"none\")",
        )
        for f in self.flush_log:
            flushes.labels(**base, bucket=str(f.bucket), reason=f.reason).inc()
            occupancy.labels(**base, bucket=str(f.bucket)).observe(f.n_real / f.batch_shape)
            served_rho.labels(**base, rho="none" if f.rho is None else str(f.rho)).inc()
        reg.counter(
            "repro_queue_violations_total",
            "Flushes later than the predicted-service deadline boundary",
        ).labels(**base).inc(self.n_violations)
        reg.counter(
            "repro_queue_infeasible_total",
            "Flushes whose oldest deadline was unmeetable at admission",
        ).labels(**base).inc(self.n_infeasible)
        reg.counter(
            "repro_queue_degraded_total",
            "Flushes served below the full posting budget",
        ).labels(**base).inc(self.n_degraded)
        depth = reg.gauge("repro_queue_depth", "Pending requests per Lq bucket lane")
        for bucket, lane in sorted(self._pending.items()):
            depth.labels(**base, bucket=str(bucket)).set(len(lane))
        return reg


def replay_arrivals(
    queue: AdmissionQueue,
    arrivals_s: Sequence[float],
    q_terms_list: Sequence[np.ndarray],
    q_weights_list: Sequence[np.ndarray],
    deadlines_ms: Sequence[float],
) -> list[Completion]:
    """Deterministically replay an arrival schedule on a simulated clock.

    The event loop advances the queue's :class:`SimulatedClock` to the next
    event — an arrival or ``next_due()`` — and polls at exactly that
    instant, so no flush can ever be observed late for lack of a wakeup.
    rids are assigned in arrival order (rid ``i`` is request ``i``).
    """
    clock = queue.clock
    if not isinstance(clock, SimulatedClock):
        raise TypeError("replay_arrivals drives time itself; queue needs a SimulatedClock")
    if not (len(arrivals_s) == len(q_terms_list) == len(q_weights_list) == len(deadlines_ms)):
        raise ValueError("arrival schedule fields must have equal length")
    inf = float("inf")
    completions: list[Completion] = []
    i, n = 0, len(arrivals_s)
    while i < n or queue.pending():
        t_arr = arrivals_s[i] if i < n else inf
        due = queue.next_due()
        t_due = due if due is not None else inf
        if t_arr <= t_due:
            clock.advance_to(t_arr)
            queue.submit(q_terms_list[i], q_weights_list[i], deadlines_ms[i])
            i += 1
        else:
            clock.advance_to(t_due)
        completions.extend(queue.poll())
    return completions
