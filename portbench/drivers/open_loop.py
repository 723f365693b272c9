"""Open loop: independent users sending requests on a Poisson schedule.

The schedule is fixed by the traffic file's rate and the window: ``rate x
seconds`` requests whose gaps are the exponential distribution's quantiles,
in an order drawn from the seed, each asking one query of the pool drawn
from the seed, so every seed sends the same arrivals in another order. One
thread sends each request when it falls due, through the port's
``AdmissionQueue.submit`` with the traffic's deadline counted from that due
time, polls the queue (which flushes through ``AnytimeServer.search_batch``),
and waits for the next arrival or the queue's next due flush. A request's
latency runs from its due time to its result on the host, so a send that
the loop makes late (it was serving a flush) counts against the system.
After the last arrival the queue is polled until every request is answered.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.correctness import Served
from portbench.drivers.common import make_server, timed_search_batch
from portbench.roofline import saat_query_bytes
from portbench.trace import span


def schedule(rate: float, seconds: float, seed: int, pool_size: int) -> tuple[np.ndarray, np.ndarray]:
    """``(arrival s from the window's start, pool query)`` of each request."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    rng = np.random.default_rng([int(seed), 1])
    t = np.cumsum(rng.permutation(gaps))
    return t * (seconds / t[-1]), rng.integers(0, pool_size, n)


def prepare(run, rate: float | None = None) -> None:
    from repro_torch.serving.queue import AdmissionQueue

    t = run.cell.traffic
    dep = run.dep
    qt, qw = dep.padded_pool()
    server = make_server(run, qt.shape[1])
    queue = AdmissionQueue(server, batch_shapes=tuple(t["batch_shapes"]),
                           safety_ms=float(t["safety_ms"]))
    warm = min(max(t["batch_shapes"]), qt.shape[0])
    server.warmup(qt[:warm], qw[:warm], batch_sizes=t["batch_shapes"])
    server.reset_stats()
    run.state.update(server=server, queue=queue)
    set_rate(run, float(t["rate_qps"]) if rate is None else rate)


def set_rate(run, rate: float) -> None:
    arrivals, queries = schedule(rate, run.seconds, run.seed, run.dep.pool_size)
    run.state.update(arrivals=arrivals, queries=queries, rate=rate)


def measure(run) -> None:
    st, t = run.state, run.cell.traffic
    queue = st["queue"]
    calls = timed_search_batch(run, st["server"])
    terms, weights = run.dep.enc.query_terms, run.dep.enc.query_weights
    arrivals, qids = st["arrivals"], st["queries"]
    deadline_ms, on = float(t["deadline_ms"]), run.trace
    n = arrivals.size
    rid0 = queue.n_submitted
    send, done = np.full(n, np.nan), np.full(n, np.nan)
    answers: dict = {}
    waits: list = []

    def stamp(completions):
        now = time.perf_counter()
        for c in completions:
            i = c.rid - rid0
            done[i] = now
            answers[i] = (c.doc_ids, c.scores)
            waits.append(c.wait_ms)

    flushes0 = len(queue.flush_log)
    t0 = time.perf_counter()
    due = t0 + arrivals
    i = 0
    while True:
        now = time.perf_counter()
        if i < n and due[i] <= now:
            with span("pb.submit", on):
                while i < n and due[i] <= now:
                    late_ms = (now - due[i]) * 1e3
                    queue.submit(terms[qids[i]], weights[qids[i]],
                                 max(deadline_ms - late_ms, 1e-3))
                    send[i] = now
                    stamp(queue.take_completions())  # a bucket that filled flushed
                    i += 1
                    now = time.perf_counter()
        with span("pb.poll", on):
            stamp(queue.poll())
        if i >= n and not queue.pending():
            break
        nd = queue.next_due()
        nxt = min(due[i] if i < n else np.inf, np.inf if nd is None else nd)
        with span("pb.wait", on):
            while True:
                now = time.perf_counter()
                if now >= nxt:
                    break
                if nxt - now > 2e-3:
                    time.sleep(nxt - now - 1e-3)
    t_end = time.perf_counter()
    run.records.update(
        window_s=t_end - t0, attempted=n, answered=len(answers),
        latency_ms=((done - due) * 1e3)[~np.isnan(done)],
        late_ms=(send - due) * 1e3,
        queue_wait_ms=np.asarray(waits),
        flush_sizes=np.asarray([f.n_real for f in queue.flush_log[flushes0:]]),
        service_ms=np.asarray([(b - a) * 1e3 for a, b, _ in calls]),
    )
    st.update(answers=answers, calls=calls, flushes=queue.flush_log[flushes0:], rid0=rid0)


def collect(run) -> tuple[list, int]:
    """The window's answers on the host, and how many requests got none;
    then the system's state is let go."""
    st = run.state
    processed = {}
    for f, (_, _, pp) in zip(st["flushes"], st["calls"]):
        pp = pp.cpu().numpy()
        for row, rid in enumerate(f.rids):
            processed[rid - st["rid0"]] = int(pp[row])
    qids = st["queries"]
    served = [Served(int(qids[i]), ids, scores, processed.get(i))
              for i, (ids, scores) in sorted(st["answers"].items())]
    n_missing = qids.size - len(served)
    run.state = {k: st[k] for k in ("queries",)}
    return served, n_missing


def reference_rho(run) -> int:
    return int(run.cell.traffic["rho"])


def work_bytes(run, reference) -> float:
    """The algorithm's bytes over every request of the window."""
    t = run.cell.traffic
    terms, weights = run.dep.enc.query_terms, run.dep.enc.query_weights
    qids, counts = np.unique(run.state["queries"], return_counts=True)
    total = 0.0
    for q, c in zip(qids, counts):
        processed, segments, live = reference.budget_counts(terms[q], weights[q], int(t["rho"]))
        total += c * saat_query_bytes(processed, segments, live, int(t["k"]))
    return total
