"""Wacky-weights characterization (paper §4.2, Table 2).

The port of ``repro.core.wacky``. Quantifies *why* learned sparse models
break DAAT skipping:

  * Table-2 term statistics (vocab size, total/unique terms per doc/query):
    "total" counts the pseudo-document trick's repeats, i.e. the sum of
    quantized weights.
  * weight-distribution shape (CV, skewness, entropy, Gini): learned models
    produce flatter, heavier-mass distributions than BM25.
  * block-max tightness: mean over postings of blockmax(t, b) / max(t).
    Tight-to-1 means a block's bound is no better than the term's global
    bound, so Block-Max structures cannot skip.
  * skip opportunity: with the true top-k threshold theta in hand, the
    fraction of (nonempty) blocks whose upper bound falls below theta, the
    headroom any DAAT algorithm has. This is the paper's central mechanism,
    measured directly.
  * accumulator overflow (16-bit JASS accumulators vs learned weights).

The statistics are numpy on the host, as the reference's. What is large
runs on the index's device: the exhaustive search that gives theta, and
the block bounds of the whole batch, which come from one
``block_prune_csr`` call at theta = -inf (the kernel on a CUDA index, its
plain version on the CPU; both equal :func:`block_upper_bounds` bit for
bit).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import quantization
from repro_torch.core.daat import csr_blockmax_offsets, max_blocks_per_term
from repro_torch.core.exhaustive import exhaustive_search
from repro_torch.core.impact_index import ImpactIndex, queries_on_device
from repro_torch.kernels.block_prune_csr import ops as prune_ops


@dataclasses.dataclass(frozen=True)
class TermStats:
    """One row of the Table 2 analogue."""

    vocab_size: int
    doc_total_terms: float  # mean sum of (quantized) weights per doc
    doc_unique_terms: float  # mean nnz per doc
    query_total_terms: float
    query_unique_terms: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def term_statistics(
    doc_idx: np.ndarray,
    term_idx: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    query_terms: Sequence[np.ndarray],
    query_weights: Sequence[np.ndarray],
    quant_bits: int = 8,
) -> TermStats:
    """Compute the Table 2 statistics from COO postings + ragged queries."""
    q, _ = quantization.quantize(weights, quantization.QuantConfig(bits=quant_bits))
    uniq = np.zeros(n_docs, dtype=np.int64)
    np.add.at(uniq, doc_idx, 1)
    total = np.zeros(n_docs, dtype=np.float64)
    np.add.at(total, doc_idx, q.astype(np.float64))
    vocab = int(np.unique(term_idx).size)
    qu = np.array([len(np.asarray(t)) for t in query_terms], dtype=np.float64)
    qt = []
    for w in query_weights:
        w = np.asarray(w, dtype=np.float64)
        qq, _ = quantization.quantize(w, quantization.QuantConfig(bits=quant_bits))
        qt.append(float(qq.sum()))
    return TermStats(
        vocab_size=vocab,
        doc_total_terms=float(total.mean()),
        doc_unique_terms=float(uniq.mean()),
        query_total_terms=float(np.mean(qt)) if qt else 0.0,
        query_unique_terms=float(qu.mean()) if qu.size else 0.0,
    )


def weight_distribution_stats(weights: np.ndarray) -> dict:
    """Shape statistics of a weight population (per retrieval model)."""
    w = np.asarray(weights, dtype=np.float64)
    w = w[w > 0]
    if w.size == 0:
        return {k: 0.0 for k in ("mean", "std", "cv", "skewness", "kurtosis", "entropy", "gini")}
    mean, std = float(w.mean()), float(w.std())
    z = (w - mean) / (std + 1e-12)
    hist, _ = np.histogram(w, bins=64, density=False)
    p = hist / max(hist.sum(), 1)
    p = p[p > 0]
    ws = np.sort(w)
    n = ws.size
    gini = float((2 * np.arange(1, n + 1) - n - 1).dot(ws) / (n * ws.sum() + 1e-12))
    return {
        "mean": mean,
        "std": std,
        "cv": std / (mean + 1e-12),
        "skewness": float((z**3).mean()),
        "kurtosis": float((z**4).mean()) - 3.0,
        "entropy": float(-(p * np.log2(p)).sum()),
        "gini": gini,
    }


def blockmax_tightness(index: ImpactIndex) -> dict:
    """How informative block maxima are. ~1.0 tightness => skipping is dead.

    ``tightness`` averages blockmax/termmax over (term, block) cells weighted
    uniformly; ``posting_weighted`` weights terms by posting count (what a
    query actually touches).
    """
    bm_w = index.bm_weight.cpu().numpy().astype(np.float64)
    bm_count = index.term_bm_count.cpu().numpy().astype(np.int64)
    tmax = index.term_max_weight.cpu().numpy().astype(np.float64)
    post = index.term_post_count.cpu().numpy().astype(np.float64)
    V = index.n_terms
    term_of_cell = np.repeat(np.arange(V + 1), bm_count)
    tm = tmax[term_of_cell]
    ok = tm > 0
    r = bm_w / np.maximum(tm, 1e-12)
    ratios = r[ok]
    per_term_cells = bm_count[term_of_cell]
    weights_post = (post[term_of_cell] / np.maximum(per_term_cells, 1))[ok]
    return {
        "tightness": float(ratios.mean()) if ratios.size else 0.0,
        "posting_weighted": float((ratios * weights_post).sum() / max(weights_post.sum(), 1e-12)),
        "cells": int(ratios.size),
        "cells_per_term_mean": float(bm_count[:V][post[:V] > 0].mean()) if V else 0.0,
    }


def batch_upper_bounds(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> torch.Tensor:
    """``f32[B, n_blocks]``: every block's bound for a ``[B, Lq]`` batch in
    one ``block_prune_csr`` call at theta = -inf, as DAAT's phase 0 takes
    them (``daat_search_batched`` with ``use_kernels=True``)."""
    base, cnt = csr_blockmax_offsets(index, q_terms, q_weights, max_bm_per_term)
    theta = torch.full((q_terms.shape[0],), float("-inf"), device=q_terms.device)
    ub, _ = prune_ops.block_prune_csr_batched(
        index.bm_block, index.bm_weight, base, cnt, q_weights.float(), theta,
        n_blocks=index.n_blocks, max_bm_per_term=max_bm_per_term,
    )
    return ub


def skip_opportunity(
    index: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    max_bm_per_term: int,
) -> dict:
    """Fraction of candidate blocks a rank-safe DAAT could skip (per query).

    theta is the *true* k-th score (from the exhaustive oracle), i.e. the best
    threshold any DAAT run could ever reach; the skippable fraction is
    therefore an upper bound on real skipping. The paper's claim: this
    collapses for learned-sparse ("wacky") weight distributions.
    ``q_terms/q_weights``: ``[B, Lq]`` tensors or arrays.
    """
    q_terms, q_weights, _ = queries_on_device(index, q_terms, q_weights)
    theta = exhaustive_search(index, q_terms, q_weights, k=k).scores[:, k - 1]  # [B]
    ub = batch_upper_bounds(index, q_terms, q_weights, max_bm_per_term)
    nonempty = ub > 0
    skippable = nonempty & (ub <= theta[:, None])
    n_nonempty = nonempty.sum(dim=-1)
    frac = skippable.sum(dim=-1).float() / torch.clamp_min(n_nonempty, 1).float()
    frac = frac.cpu().numpy().astype(np.float64)
    return {
        "skippable_fraction_mean": float(frac.mean()),
        "skippable_fraction_p10": float(np.percentile(frac, 10)),
        "skippable_fraction_p90": float(np.percentile(frac, 90)),
        "candidate_blocks_mean": float(n_nonempty.to(torch.int32).cpu().numpy().mean()),
    }


def accumulator_overflow(index: ImpactIndex, query_weight_max: float = 1.0) -> dict:
    """The 16-vs-32-bit JASS accumulator observation (paper §3.2)."""
    sums = index.doc_weight_sum.cpu().numpy().astype(np.float64)
    sums = sums[: index.n_docs]
    return quantization.accumulator_analysis(sums, query_weight_max=query_weight_max, bits=16)


def full_report(
    name: str,
    index: ImpactIndex,
    doc_weights_raw: np.ndarray,
    q_terms,
    q_weights,
    *,
    k: int = 10,
    max_bm_per_term: int | None = None,
) -> dict:
    """One consolidated wackiness report per retrieval model."""
    if max_bm_per_term is None:
        max_bm_per_term = max_blocks_per_term(index)
    return {
        "model": name,
        "weights": weight_distribution_stats(doc_weights_raw),
        "blockmax": blockmax_tightness(index),
        "skip": skip_opportunity(
            index, q_terms, q_weights, k=k, max_bm_per_term=max_bm_per_term
        ),
        "accumulator": accumulator_overflow(index),
    }
