"""IR effectiveness metrics and the rho-degradation effectiveness harness.

Point metrics: RR@10 (the paper's official metric), Recall@k, NDCG@k, and
top-k overlap. On top of them this module quantifies the paper's serving
trade — *what does each rho level cost in effectiveness?* — two ways:

  * :func:`rho_effectiveness_sweep` serves a labeled query set directly at
    every ladder level and reports per-rho Recall@k/MRR/NDCG plus relative
    loss against the exhaustive (max-rho) level;
  * :func:`replay_effectiveness` / :func:`effectiveness_surface` push the
    same labeled set through a continuous-batching
    :class:`~repro_torch.serving.queue.AdmissionQueue` *under load*, so the rho
    each query was actually served at is decided by the deadline-driven
    flush policy (``degrade_rho``), and effectiveness is accounted per
    served level — the effectiveness-vs-rho-vs-deadline surface behind the
    paper's "≤3% loss buys large mean/tail gains" claim.

Qrels replay format
-------------------
A labeled replay is four parallel sequences, one entry per request ``i``
(request ``i`` gets rid ``i``, so completions re-align by rid):

  * ``arrivals_s[i]``   — arrival instant (seconds, clock domain), ascending;
  * ``q_terms_list[i]`` / ``q_weights_list[i]`` — the ragged query (int term
    ids / float weights, trailing padding allowed);
  * ``qrels[i]``        — the single relevant doc id (MS MARCO style). The
    point metrics also accept ``[n_queries, R]`` graded qrels with ``-1``
    padding (see :func:`ndcg_at_k`), but the replay harness keys its
    per-rho grouping on the 1-D form.

Queries are replayed on the queue's injectable clock: a
:class:`~repro_torch.metrics.latency.SimulatedClock` makes the whole surface a
deterministic function of the schedule (CI), a
:class:`~repro_torch.metrics.latency.HybridClock` keeps the scripted arrivals but
accrues real measured service time (load rehearsal).

The port of ``repro.metrics.ir_metrics`` (numpy only). The server-taking
helpers are duck-typed: a server needs ``search_batch(q_terms, q_weights,
rho=)`` returning an object with ``doc_ids``, ``cfg.batch_size`` and
``rho_ladder``; a result on the device comes back to the host here.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np


def mrr_at_k(ranked_doc_ids: np.ndarray, qrels: np.ndarray, k: int = 10) -> float:
    """Mean reciprocal rank at cutoff k.

    Args:
      ranked_doc_ids: [n_queries, >=k] doc ids in decreasing score order.
      qrels: [n_queries] the single relevant doc per query (MS MARCO style).
    """
    ranked = np.asarray(ranked_doc_ids)[:, :k]
    if ranked.shape[0] == 0:
        return 0.0  # empty query set: defined as 0, not a nan mean
    rel = np.asarray(qrels).reshape(-1, 1)
    hits = ranked == rel
    ranks = np.argmax(hits, axis=1) + 1
    rr = np.where(hits.any(axis=1), 1.0 / ranks, 0.0)
    return float(rr.mean())


def recall_at_k(ranked_doc_ids: np.ndarray, qrels: np.ndarray, k: int = 1000) -> float:
    ranked = np.asarray(ranked_doc_ids)[:, :k]
    if ranked.shape[0] == 0:
        return 0.0
    rel = np.asarray(qrels).reshape(-1, 1)
    return float((ranked == rel).any(axis=1).mean())


def ndcg_at_k(
    ranked_doc_ids: np.ndarray,
    qrel_ids: np.ndarray,
    k: int = 10,
    qrel_gains: np.ndarray | None = None,
) -> float:
    """Mean NDCG at cutoff k with graded relevance.

    Args:
      ranked_doc_ids: ``[n_queries, >=k]`` doc ids in decreasing score order.
        A cutoff larger than the ranking just uses the whole ranking.
      qrel_ids: ``[n_queries, R]`` relevant doc ids per query, ``-1`` padding
        for queries with fewer than R judged docs. A 1-D array is treated as
        one relevant doc per query (MS MARCO style).
      qrel_gains: optional ``[n_queries, R]`` graded gains aligned with
        ``qrel_ids``; omitted = binary relevance (gain 1 per judged doc).
        Pad slots are ignored regardless of their gain value.

    Uses the standard ``gain / log2(rank + 1)`` discount; the ideal DCG sorts
    each query's (unpadded) gains descending and truncates at k. Queries with
    no judged docs contribute 0 (the sklearn/trec_eval convention), so adding
    unjudged queries can only lower the mean — never inflate it.
    """
    ranked = np.asarray(ranked_doc_ids)[:, :k]
    if ranked.shape[0] == 0:
        return 0.0
    rels = np.asarray(qrel_ids)
    if rels.ndim == 1:
        rels = rels.reshape(-1, 1)
    if qrel_gains is None:
        gains = np.ones(rels.shape, np.float64)
    else:
        gains = np.asarray(qrel_gains, np.float64)
        if gains.shape != rels.shape:
            raise ValueError(
                f"qrel_gains shape {gains.shape} != qrel_ids shape {rels.shape}"
            )
    live = rels >= 0
    gains = np.where(live, gains, 0.0)
    # gain of each ranked slot: matched judged doc's gain, else 0. Judged ids
    # are unique per query, so the sum over R picks at most one gain per slot.
    slot_gain = np.einsum(
        "qkr,qr->qk", (ranked[:, :, None] == rels[:, None, :]) & live[:, None, :], gains
    )
    discount = 1.0 / np.log2(np.arange(ranked.shape[1]) + 2.0)
    dcg = slot_gain @ discount
    ideal = -np.sort(-gains, axis=1)[:, : ranked.shape[1]]
    idcg = ideal @ discount[: ideal.shape[1]]
    return float(np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0).mean())


def rank_overlap(ids_a: np.ndarray, ids_b: np.ndarray, k: int) -> float:
    """Mean top-k set overlap between two systems (rank-safety diagnostics)."""
    a = np.asarray(ids_a)[:, :k]
    b = np.asarray(ids_b)[:, :k]
    out = []
    for i in range(a.shape[0]):
        out.append(len(np.intersect1d(a[i], b[i])) / k)
    return float(np.mean(out))


# --------------------------------------------------------------------------
# the rho-degradation effectiveness harness
# --------------------------------------------------------------------------


def effectiveness_report(
    ranked_doc_ids: np.ndarray,
    qrels: np.ndarray,
    *,
    recall_k: int = 100,
    mrr_k: int = 10,
    ndcg_k: int = 10,
) -> dict:
    """The harness's standard metric triple for one ranking set."""
    return {
        "mrr": mrr_at_k(ranked_doc_ids, qrels, mrr_k),
        "recall": recall_at_k(ranked_doc_ids, qrels, recall_k),
        "ndcg": ndcg_at_k(ranked_doc_ids, qrels, ndcg_k),
        "mrr_k": mrr_k,
        "recall_k": recall_k,
        "ndcg_k": ndcg_k,
    }


def _relative_loss(value: float, exact: float) -> float:
    """Fractional effectiveness lost vs the exhaustive level (floored at 0:
    a budget that happens to beat exhaustive on a small label set is not a
    negative loss the 3%-tolerance selector should reward)."""
    if exact <= 0.0:
        return 0.0
    return max(0.0, (exact - value) / exact)


def _serve_ids_at_rho(server, q_terms, q_weights, rho, batch_size):
    N = q_terms.shape[0]
    out = []
    for lo in range(0, N, batch_size):
        hi = min(lo + batch_size, N)
        bt, bw = q_terms[lo:hi], q_weights[lo:hi]
        if hi - lo < batch_size:  # pad final batch (served, then dropped)
            pad = batch_size - (hi - lo)
            bt = np.concatenate([bt, np.repeat(bt[-1:], pad, 0)])
            bw = np.concatenate([bw, np.repeat(bw[-1:], pad, 0)])
        res = server.search_batch(bt, bw, rho=rho)
        ids = res.doc_ids  # a device tensor comes back to the host here
        out.append(np.asarray(ids.cpu() if hasattr(ids, "cpu") else ids)[: hi - lo])
    return np.concatenate(out)


def rho_effectiveness_sweep(
    server,
    q_terms: np.ndarray,  # [N, Lq]
    q_weights: np.ndarray,
    qrels: np.ndarray,  # [N] single relevant doc per query
    *,
    recall_k: int = 100,
    mrr_k: int = 10,
    ndcg_k: int = 10,
    batch_size: Optional[int] = None,
) -> list:
    """Serve a labeled set at EVERY ladder level; one row per rho.

    Each row carries the metric triple plus ``loss_mrr/loss_recall/loss_ndcg``
    — relative loss against the exhaustive level (the ladder top, which the
    server caps at the index's own posting count). This is the direct
    (no-queue) arm of the harness: what each budget costs in effectiveness,
    independent of load.
    """
    qt = np.asarray(q_terms)
    qw = np.asarray(q_weights)
    rels = np.asarray(qrels)
    bs = int(batch_size) if batch_size is not None else int(server.cfg.batch_size)
    rows = []
    by_rho = {}
    for rho in server.rho_ladder:
        ids = _serve_ids_at_rho(server, qt, qw, rho, bs)
        by_rho[rho] = effectiveness_report(
            ids, rels, recall_k=recall_k, mrr_k=mrr_k, ndcg_k=ndcg_k
        )
    exact = by_rho[server.rho_ladder[-1]]
    for rho in server.rho_ladder:
        rep = by_rho[rho]
        rows.append(
            {
                "rho": int(rho),
                "exact": rho == server.rho_ladder[-1],
                **rep,
                "loss_mrr": _relative_loss(rep["mrr"], exact["mrr"]),
                "loss_recall": _relative_loss(rep["recall"], exact["recall"]),
                "loss_ndcg": _relative_loss(rep["ndcg"], exact["ndcg"]),
            }
        )
    return rows


def cheapest_rho_within_loss(
    sweep_rows: Sequence[dict], *, max_loss: float = 0.03, metric: str = "mrr"
) -> int:
    """Smallest ladder level within ``max_loss`` relative loss of exhaustive.

    This is "the largest tolerable degradation": the most aggressive posting
    budget the paper's ≤3%-effectiveness-loss tolerance admits (every level
    at or above it also qualifies — the sweep's losses are what make the
    claim auditable). When NO level is within tolerance (a ``max_loss``
    below the exhaustive level's own 0.0, or a partial sweep that lost its
    exact row) the answer is the exact budget itself — the level that
    *defines* zero loss — never ``None``: callers feed the result straight
    into a rho ladder, and "no tolerable degradation" means "don't degrade",
    not "crash the serving config".
    """
    rows = list(sweep_rows)
    if not rows:
        raise ValueError("cheapest_rho_within_loss needs a non-empty sweep")
    key = f"loss_{metric}"
    fits = [r for r in rows if r[key] <= max_loss]
    if fits:
        return int(min(fits, key=lambda r: r["rho"])["rho"])
    exact_rows = [r for r in rows if r.get("exact")] or rows
    return int(max(exact_rows, key=lambda r: r["rho"])["rho"])


def replay_effectiveness(
    queue,
    arrivals_s: Sequence[float],
    q_terms_list: Sequence[np.ndarray],
    q_weights_list: Sequence[np.ndarray],
    deadlines_ms: Sequence[float],
    qrels: np.ndarray,
    *,
    recall_k: int = 100,
    mrr_k: int = 10,
    ndcg_k: int = 10,
) -> dict:
    """Push a labeled arrival schedule through an AdmissionQueue and account
    effectiveness per rho level *actually served* (see the module docstring
    for the replay format).

    The flush policy — not the caller — decides each request's budget, so
    under overload with ``degrade_rho=True`` the report shows exactly what
    the SLO cost: which fraction of traffic was degraded, to which levels,
    and what each level scored on the labels. Returns one surface row::

        {"n_requests", "violations", "infeasible", "degraded_flushes",
         "wait_ms": {...percentiles...}, "overall": {metric triple},
         "by_rho": [{"rho", "n_queries", ...metric triple...}, ...]}
    """
    from repro_torch.metrics.latency import summarize_latencies  # lazy: no cycle
    from repro_torch.serving.queue import replay_arrivals

    rels = np.asarray(qrels)
    if rels.ndim != 1:
        raise ValueError(
            f"replay harness needs 1-D single-relevant qrels, got {rels.shape}"
        )
    if len(arrivals_s) != rels.shape[0]:
        raise ValueError(
            f"{len(arrivals_s)} arrivals vs {rels.shape[0]} qrels entries"
        )
    comps = replay_arrivals(queue, arrivals_s, q_terms_list, q_weights_list, deadlines_ms)
    comps = sorted(comps, key=lambda c: c.rid)
    if not comps:
        # an empty schedule served nothing at any rho: a well-formed all-zero
        # report, not an np.stack([]) crash deep in the accounting
        return {
            "n_requests": 0,
            "violations": queue.n_violations,
            "infeasible": queue.n_infeasible,
            "degraded_flushes": queue.n_degraded,
            "wait_ms": {k: round(v, 4) for k, v in summarize_latencies([]).row().items()},
            "overall": effectiveness_report(
                np.zeros((0, 1), np.int32), rels[:0],
                recall_k=recall_k, mrr_k=mrr_k, ndcg_k=ndcg_k,
            ),
            "by_rho": [],
        }
    ids = np.stack([c.doc_ids for c in comps])
    served_rho = [c.rho for c in comps]
    waits = summarize_latencies([c.wait_ms for c in comps])
    by_rho = []
    for rho in sorted({r for r in served_rho if r is not None}):
        pick = np.asarray([r == rho for r in served_rho])
        if not pick.any():
            continue  # a level nothing completed at contributes no row
        by_rho.append(
            {
                "rho": int(rho),
                "n_queries": int(pick.sum()),
                **effectiveness_report(
                    ids[pick], rels[pick], recall_k=recall_k, mrr_k=mrr_k, ndcg_k=ndcg_k
                ),
            }
        )
    return {
        "n_requests": len(comps),
        "violations": queue.n_violations,
        "infeasible": queue.n_infeasible,
        "degraded_flushes": queue.n_degraded,
        "wait_ms": {k: round(v, 4) for k, v in waits.row().items()},
        "overall": effectiveness_report(
            ids, rels, recall_k=recall_k, mrr_k=mrr_k, ndcg_k=ndcg_k
        ),
        "by_rho": by_rho,
    }


def effectiveness_surface(
    queue_factory: Callable[[float], object],
    deadlines_ms: Sequence[float],
    arrivals_s: Sequence[float],
    q_terms_list: Sequence[np.ndarray],
    q_weights_list: Sequence[np.ndarray],
    qrels: np.ndarray,
    **report_kw,
) -> list:
    """Effectiveness-vs-rho-vs-deadline surface: one replay per deadline.

    ``queue_factory(deadline_ms)`` must build a FRESH queue (and state) for
    each replay — reusing one queue would leak calibration and flush logs
    across deadline points. Each row is :func:`replay_effectiveness`'s dict
    plus the ``deadline_ms`` that produced it: tightening the deadline
    shifts traffic down the rho ladder, and the surface shows what that
    costs on the labels.
    """
    rows = []
    for d in deadlines_ms:
        queue = queue_factory(float(d))
        row = replay_effectiveness(
            queue,
            arrivals_s,
            q_terms_list,
            q_weights_list,
            [float(d)] * len(arrivals_s),
            qrels,
            **report_kw,
        )
        row["deadline_ms"] = float(d)
        rows.append(row)
    return rows
