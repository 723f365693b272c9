"""Exhaustive ranked disjunction: score every document, then top-k.

The port of ``repro.core.exhaustive``, the rank-safe oracle. Plain PyTorch:
the reference has no kernel here. ``score_d = sum_j qvec[term_dj] * w_dj``
over the doc-major store. One query's gather is ``[n_docs_pad, Tmax]``
(about 0.7 GB at a 276k-doc shard), so the batch is scored one query at a
time.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.impact_index import ImpactIndex, query_vector
from repro_torch.core.topk import topk


class ExhaustiveResult(NamedTuple):
    scores: torch.Tensor  # f32[..., k]
    doc_ids: torch.Tensor  # i32[..., k]


def score_all_docs(index: ImpactIndex, qvec: torch.Tensor) -> torch.Tensor:
    """Scores for every (padded) document; pad docs = -inf. f32[n_docs_pad]."""
    scores = torch.sum(qvec[index.doc_terms.long()] * index.doc_weights, dim=-1)
    live = torch.arange(scores.shape[0], device=scores.device) < index.n_docs
    return torch.where(live, scores, float("-inf"))


def exhaustive_search(index: ImpactIndex, q_terms, q_weights, *, k: int) -> ExhaustiveResult:
    """Batched rank-safe top-k by scoring the full corpus. ``[B, Lq]`` inputs."""
    dev = index.device
    q_terms = torch.as_tensor(q_terms, device=dev)
    q_weights = torch.as_tensor(q_weights, device=dev)
    scores, ids = [], []
    for qt, qw in zip(q_terms, q_weights):
        s, i = topk(score_all_docs(index, query_vector(index, qt, qw)), k)
        scores.append(s)
        ids.append(i.to(torch.int32))
    return ExhaustiveResult(torch.stack(scores), torch.stack(ids))
