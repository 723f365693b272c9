"""Closed loop: one client dispatching batches back to back.

The client walks the query pool in an order drawn from the seed (a new
permutation each pass), ``batch`` queries at a time padded to the pool's
longest query, through ``AnytimeServer.search_batch``, and copies each
batch's ids, scores and work counts to the host before it sends the next.
It starts batches until the window's seconds have passed; the rate is every
query answered over the time from the first dispatch to the last answer.
"""
from __future__ import annotations

import time

import numpy as np

from portbench.correctness import Served
from portbench.drivers.common import make_server
from portbench.roofline import daat_query_bytes
from portbench.trace import span


def batch_order(seed: int, pool_size: int, n_batches: int, batch: int) -> np.ndarray:
    """Pool indices of the first ``n_batches`` batches: passes over the pool,
    each in its own seeded order."""
    rng = np.random.default_rng([int(seed), 2])
    need = n_batches * batch
    passes = [rng.permutation(pool_size) for _ in range(-(-need // pool_size))]
    return np.concatenate(passes)[:need].reshape(n_batches, batch)


def prepare(run) -> None:
    t = run.cell.traffic
    qt, qw = run.dep.padded_pool()
    server = make_server(run, qt.shape[1])
    b = int(t["batch"])
    server.warmup(qt[:b], qw[:b], batch_sizes=[b])
    server.reset_stats()
    run.state.update(server=server, qt=qt, qw=qw)


def measure(run) -> None:
    st, t = run.state, run.cell.traffic
    server, qt, qw = st["server"], st["qt"], st["qw"]
    b, on = int(t["batch"]), run.trace
    order = batch_order(run.seed, qt.shape[0], int(t["max_batches"]), b)
    spans, results = [], []
    t0 = time.perf_counter()
    t_stop = t0 + run.seconds
    for rows in order:
        if time.perf_counter() >= t_stop:
            break
        with span("pb.search_batch", on):
            a = time.perf_counter()
            res = server.search_batch(qt[rows], qw[rows])
            z = time.perf_counter()
        with span("pb.results", on):
            results.append((rows, res.doc_ids.cpu().numpy(), res.scores.cpu().numpy(),
                            res.chunks.cpu().numpy(), res.blocks_scored.cpu().numpy()))
        spans.append((a, z))
    t_end = time.perf_counter()
    n = sum(r[0].size for r in results)
    scored = np.concatenate([r[4] for r in results]) if results else np.zeros(0)
    run.records.update(
        window_s=t_end - t0, attempted=n, answered=n, queries_per_s=n / (t_end - t0),
        batch_ms=np.asarray([(z - a) * 1e3 for a, z in spans]),
        trips_max=np.asarray([int(r[3].max()) for r in results]),
        blocks_scored_pct=100.0 * scored / server.index.n_blocks,
    )
    if len(results) == len(order):
        raise RuntimeError(f"the window outlasted max_batches={len(order)}; raise it")
    st["results"] = results


def probe(run) -> None:
    """Host reads of the device in a few batches' engine dispatch (after the
    window), counted by the port's op recorder."""
    import torch
    from repro_torch.analysis.op_trace import record
    from repro_torch.serving.bucketing import bucketize_batch

    st, t = run.state, run.cell.traffic
    server, b = st["server"], int(t["batch"])
    order = batch_order(run.seed + 1, st["qt"].shape[0], int(t["probe_batches"]), b)
    reads = []
    for rows in order:
        bt, bw, _ = bucketize_batch(st["qt"][rows], st["qw"][rows], server.lq_buckets,
                                    server.index.n_terms)
        qtd = torch.as_tensor(bt, dtype=torch.int32, device=server.device)
        qwd = torch.as_tensor(bw, dtype=torch.float32, device=server.device)
        reads.append(len(record(server.engine_fn(), qtd, qwd).reads()))
    run.records["host_reads"] = np.asarray(reads)


def collect(run) -> tuple[list, int]:
    served = []
    blocks = []
    for rows, ids, scores, _, scored in run.state["results"]:
        for i, q in enumerate(rows):
            served.append(Served(int(q), ids[i], scores[i]))
            blocks.append((int(q), int(scored[i])))
    run.state = {"blocks": blocks}
    return served, 0


def reference_rho(run):
    return None


def work_bytes(run, reference) -> float:
    """The algorithm's bytes over every query of the window."""
    k = int(run.cell.traffic["k"])
    terms, weights = run.dep.enc.query_terms, run.dep.enc.query_weights
    pairs, counts = np.unique(np.asarray(run.state["blocks"], dtype=np.int64).reshape(-1, 2),
                              axis=0, return_counts=True)
    total = 0.0
    for (q, scored), c in zip(pairs, counts):
        bm, slots, matched = reference.block_work(terms[q], weights[q], int(scored))
        live = int((np.asarray(weights[q]) > 0).sum())
        total += c * daat_query_bytes(bm, slots, matched, live, k)
    return total
