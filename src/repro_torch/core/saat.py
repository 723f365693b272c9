"""Anytime score-at-a-time (SAAT) query evaluation, natively batched.

The port of ``repro.core.saat``. JASS processes impact-ordered posting
segments in decreasing order of score contribution (segment impact x query
weight) and stops after ``rho`` postings, yielding an approximate top-k
whose cost is bounded by construction.

For a ``[B, Lq]`` batch: the planner orders each query's candidate segments
by contribution with one stable sort, the gather maps the first ``rho``
posting slots onto (segment, offset) pairs with one batched
``searchsorted`` over the segment-length prefix sums, and the scatter adds
the contributions into per-query accumulators.

``scatter_impl`` picks the scatter:
  * ``"scatter"``  plain ``index_add_`` in contribution order (the
                   reference's ``"jnp"``);
  * ``"sort"``     stable sort by doc, then the same ``index_add_`` (the
                   reference's ``"sort"``);
  * ``"kernel"``   the ``impact_scatter`` CUDA kernel (the reference's
                   ``"pallas"``).
``fused_topk=True`` runs the ``impact_scatter_topk`` CUDA kernel's segment
entry instead, which fuses the gather and the top-k into the scatter: it
reads each admitted posting's doc straight from the index through the plan,
so neither the ``[B, rho]`` postings nor the accumulator reach device
memory, and ``scatter_impl`` is ignored. On CPU tensors both kernel routes
run their plain PyTorch versions.

``saat_search_vmap`` runs the same search one query at a time (the
reference's ``jax.vmap`` of one query, as a loop): the parity oracle of the
batched engine, whose ``"kernel"`` route is the single-query
``impact_scatter`` wrapper.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.impact_index import ImpactIndex, queries_on_device
from repro_torch.core.topk import topk
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops
from repro_torch.metrics import spans

SCATTER_IMPLS = ("scatter", "sort", "kernel")


class SaatPlan(NamedTuple):
    """Per-query segment schedule, ordered by decreasing contribution.
    All fields carry the query batch dims in front (``[..., n_cand]``)."""

    starts: torch.Tensor  # i32[..., n_cand] posting-store offsets
    contribs: torch.Tensor  # f32[..., n_cand] per-posting score contribution
    cum_len: torch.Tensor  # i32[..., n_cand] inclusive prefix sum of segment lengths
    total_postings: torch.Tensor  # i32[...] total candidate postings


class SaatResult(NamedTuple):
    scores: torch.Tensor  # f32[..., k]
    doc_ids: torch.Tensor  # i32[..., k]
    postings_processed: torch.Tensor  # i32[...]
    total_postings: torch.Tensor  # i32[...]


def max_segments_per_term(index: ImpactIndex) -> int:
    """Static bound for plan shapes (recorded at build time as
    ``index.max_segs``; reduced from the index otherwise). At least 1, so
    a corpus with no postings still has a plan axis to index."""
    if index.max_segs > 0:
        return int(index.max_segs)
    return max(1, int(index.term_seg_count.max()))


def saat_plan(
    index: ImpactIndex,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    max_segs_per_term: int,
) -> SaatPlan:
    """Build the contribution-ordered segment schedule for ``[..., Lq]``
    queries: one stable sort over ``[..., Lq * max_segs_per_term]``."""
    t = torch.where(q_weights > 0, q_terms, index.n_terms).long()  # pad slot has no segments
    base = index.term_seg_start[t]  # [..., Lq]
    cnt = torch.clamp_max(index.term_seg_count[t], max_segs_per_term)
    offs = torch.arange(max_segs_per_term, dtype=torch.int32, device=t.device)
    j = base[..., :, None] + offs  # [..., Lq, M]
    valid = offs < cnt[..., :, None]
    j = torch.where(valid, j, 0).long()
    contrib = index.seg_weight[j] * q_weights[..., :, None].float()
    contrib = torch.where(valid, contrib, float("-inf"))
    lens = torch.where(valid, index.seg_len[j], 0)
    starts = torch.where(valid, index.seg_start[j], 0)

    flat_shape = contrib.shape[:-2] + (contrib.shape[-2] * contrib.shape[-1],)
    flat_c = contrib.reshape(flat_shape)
    # decreasing contribution (JASS order); stable, as jnp.argsort is
    order = torch.sort(-flat_c, dim=-1, stable=True).indices
    starts = torch.gather(starts.reshape(flat_shape), -1, order)
    lens = torch.gather(lens.reshape(flat_shape), -1, order)
    sorted_c = torch.gather(flat_c, -1, order)
    contribs = torch.where(torch.isfinite(sorted_c), sorted_c, 0.0)
    cum = torch.cumsum(lens, dim=-1, dtype=torch.int32)
    return SaatPlan(starts=starts, contribs=contribs, cum_len=cum, total_postings=cum[..., -1])


def _gather_postings_batched(
    index: ImpactIndex, plan: SaatPlan, rho: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Map posting slots [0, rho) of each query -> (doc_id, contribution,
    n_processed). Slots past a query's total carry doc 0 and contribution 0.

    ``j[b, p] = #{i : cum[b, i] <= p}`` is a right-sided ``searchsorted``,
    the same integers as the reference's histogram prefix sum.
    """
    B, n_cand = plan.cum_len.shape
    p = torch.arange(rho, dtype=torch.int32, device=plan.cum_len.device).expand(B, rho)
    j = torch.searchsorted(plan.cum_len, p.contiguous(), right=True)
    j = torch.clamp_max(j, n_cand - 1)
    prev_cum = torch.gather(plan.cum_len, -1, torch.clamp_min(j - 1, 0))
    prev = torch.where(j > 0, prev_cum, 0)
    offset = p - prev
    pidx = torch.gather(plan.starts, -1, j) + offset
    valid = p < plan.total_postings[:, None]
    docs = index.doc_ids[torch.where(valid, pidx, 0).long()]
    contribs = torch.where(valid, torch.gather(plan.contribs, -1, j), 0.0)
    docs = torch.where(valid, docs, 0)
    n_processed = torch.clamp_max(plan.total_postings, rho).to(torch.int32)
    return docs, contribs, n_processed


def _gather_postings(
    index: ImpactIndex, plan: SaatPlan, rho: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-query form of :func:`_gather_postings_batched`: posting slots
    [0, rho) of one ``[n_cand]`` plan -> ``(doc_id, contribution,
    n_processed)``."""
    p = torch.arange(rho, dtype=torch.int32, device=plan.cum_len.device)
    j = torch.searchsorted(plan.cum_len, p, right=True)
    j = torch.clamp_max(j, plan.cum_len.shape[0] - 1)
    prev = torch.where(j > 0, plan.cum_len[torch.clamp_min(j - 1, 0)], 0)
    pidx = plan.starts[j] + (p - prev)
    valid = p < plan.total_postings
    docs = torch.where(valid, index.doc_ids[torch.where(valid, pidx, 0).long()], 0)
    contribs = torch.where(valid, plan.contribs[j], 0.0)
    n_processed = torch.clamp_max(plan.total_postings, rho).to(torch.int32)
    return docs, contribs, n_processed


def _accumulate(index: ImpactIndex, docs: torch.Tensor, contribs: torch.Tensor,
                scatter_impl: str) -> torch.Tensor:
    """Single-query scatter: ``docs/contribs [rho]`` -> ``acc [n_docs_pad]``."""
    n_docs_pad = index.doc_terms.shape[0]
    if scatter_impl == "scatter":
        acc = torch.zeros(n_docs_pad, dtype=torch.float32, device=docs.device)
        return acc.index_add_(0, docs.long(), contribs)
    if scatter_impl == "sort":
        sd, order = torch.sort(docs, stable=True)
        acc = torch.zeros(n_docs_pad, dtype=torch.float32, device=docs.device)
        return acc.index_add_(0, sd.long(), contribs[order])
    if scatter_impl == "kernel":
        return scatter_ops.impact_scatter(docs, contribs, n_docs_pad)
    raise ValueError(f"unknown scatter_impl {scatter_impl!r}; choose from {SCATTER_IMPLS}")


def _index_add_rows(docs: torch.Tensor, contribs: torch.Tensor, n_docs_pad: int) -> torch.Tensor:
    B = docs.shape[0]
    keys = docs.long() + torch.arange(B, device=docs.device)[:, None] * n_docs_pad
    acc = torch.zeros(B * n_docs_pad, dtype=torch.float32, device=docs.device)
    acc.index_add_(0, keys.reshape(-1), contribs.reshape(-1))
    return acc.view(B, n_docs_pad)


def _accumulate_batched(
    index: ImpactIndex, docs: torch.Tensor, contribs: torch.Tensor, scatter_impl: str
) -> torch.Tensor:
    """Batch-aware scatter: ``docs/contribs [B, rho]`` -> ``acc [B, n_docs_pad]``."""
    n_docs_pad = index.doc_terms.shape[0]
    if scatter_impl == "scatter":
        return _index_add_rows(docs, contribs, n_docs_pad)
    if scatter_impl == "sort":
        sd, order = torch.sort(docs, dim=-1, stable=True)
        return _index_add_rows(sd, torch.gather(contribs, -1, order), n_docs_pad)
    if scatter_impl == "kernel":
        return scatter_ops.impact_scatter_batched(docs, contribs, n_docs_pad)
    raise ValueError(f"unknown scatter_impl {scatter_impl!r}; choose from {SCATTER_IMPLS}")


def _mask_pad_docs(
    index: ImpactIndex, acc: torch.Tensor, live_mask: torch.Tensor | None = None
) -> torch.Tensor:
    n_docs_pad = acc.shape[-1]
    live = torch.arange(n_docs_pad, device=acc.device) < index.n_docs
    if live_mask is not None:
        live = live & (live_mask != 0)
    return torch.where(live, acc, float("-inf"))


# The keyword arguments that shape a batched search: the serving layer's
# ``executable_key`` names a dispatch by these, as the reference names its
# jit cache entry (the reference passes this tuple to ``jax.jit``).
SAAT_STATICS = ("k", "rho", "max_segs_per_term", "scatter_impl", "fused_topk")


def saat_search(
    index: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    rho: int,
    max_segs_per_term: int,
    scatter_impl: str = "scatter",
    fused_topk: bool = False,
    live_mask: torch.Tensor | None = None,
) -> SaatResult:
    """Natively batched anytime SAAT top-k. ``q_terms/q_weights: [B, Lq]``
    (tensors or arrays; they are moved to the index's device).

    ``rho`` is the JASS posting budget; any ``rho`` at or above a query's
    own total is rank-safe for it (the executor stops at the total).

    ``live_mask`` is the tombstone gate: an i32/bool ``[n_docs_pad]`` bitmap
    (nonzero = live) ANDed into the pad mask, so tombstoned docs score
    ``-inf``. The accumulation is untouched.

    The fused route bounds each row by its own total on the device and
    reads nothing on the host. The other routes gather ``[B, rho]`` slots;
    at the exact level (``rho >= index.n_postings``) their gather stops at
    the batch's largest candidate total (one host read): slots past a
    query's total carry nothing, and eager PyTorch keeps no static shapes,
    so the results are unchanged while the ``[B, n_postings]`` arrays of an
    exact budget never reach the device's memory.
    """
    q_terms, q_weights, live_mask = queries_on_device(index, q_terms, q_weights, live_mask)
    if q_terms.ndim != 2:
        raise ValueError(f"expected [B, Lq] query batch, got shape {tuple(q_terms.shape)}")
    with spans.span("saat.plan"):
        plan = saat_plan(index, q_terms, q_weights, max_segs_per_term)
    if fused_topk:
        scores, ids = fused_ops.impact_scatter_topk_segments(
            index.doc_ids, plan.starts, plan.contribs, plan.cum_len, rho,
            index.doc_terms.shape[0], k, n_live=index.n_docs, live=live_mask)
        n_proc = torch.clamp_max(plan.total_postings, min(rho, 2**31 - 1)).to(torch.int32)
        return SaatResult(scores, ids.to(torch.int32), n_proc, plan.total_postings)
    if rho >= index.n_postings:
        rho = min(rho, max(1, int(plan.total_postings.max())))
    with spans.span("saat.gather", rho=rho):
        docs, contribs, n_proc = _gather_postings_batched(index, plan, rho)
    acc = _accumulate_batched(index, docs, contribs, scatter_impl)
    scores, ids = topk(_mask_pad_docs(index, acc, live_mask), k)
    return SaatResult(scores, ids.to(torch.int32), n_proc, plan.total_postings)


def saat_search_vmap(
    index: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    rho: int,
    max_segs_per_term: int,
    scatter_impl: str = "scatter",
    live_mask: torch.Tensor | None = None,
) -> SaatResult:
    """Anytime SAAT one query at a time: the parity oracle of
    :func:`saat_search` (the reference's ``jax.vmap`` of one query, as a
    loop), with the same ``scatter_impl`` names and the same ``live_mask``,
    shared by the batch. ``q_terms/q_weights: [B, Lq]``."""
    q_terms, q_weights, live_mask = queries_on_device(index, q_terms, q_weights, live_mask)
    if q_terms.ndim != 2:
        raise ValueError(f"expected [B, Lq] query batch, got shape {tuple(q_terms.shape)}")
    rows = []
    for qt, qw in zip(q_terms, q_weights):
        plan = saat_plan(index, qt, qw, max_segs_per_term)
        docs, contribs, n_proc = _gather_postings(index, plan, rho)
        acc = _accumulate(index, docs, contribs, scatter_impl)
        scores, ids = topk(_mask_pad_docs(index, acc, live_mask), k)
        rows.append(SaatResult(scores, ids.to(torch.int32), n_proc, plan.total_postings))
    return SaatResult(*(torch.stack(field) for field in zip(*rows)))


def exact_rho(index: ImpactIndex) -> int:
    """A rho that guarantees rank-safe evaluation for any query."""
    return index.n_postings
