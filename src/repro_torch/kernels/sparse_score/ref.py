"""Plain PyTorch version of the match-and-accumulate scorer.

``score_d = sum_j w_dj * qv(term_dj)`` with ``qv(t) = sum_l [t == qt_l] * qw_l``
added in slot order, one query slot at a time over the whole ``[B, N, Tmax]``
tile: no ``[..., Lq]`` one-hot is built, so the card holds a main-path tile.
``sparse_score_blocks_ref`` is the store-addressed entry's: the selected
blocks' rows gathered from the index's store, scored, then masked.
"""
from __future__ import annotations

import torch


def sparse_score_batched_ref(
    doc_terms: torch.Tensor,  # i32[B, N, Tmax]
    doc_weights: torch.Tensor,  # f32[B, N, Tmax]
    q_terms: torch.Tensor,  # i32[B, Lq]
    q_weights: torch.Tensor,  # f32[B, Lq] (0 for padding slots)
) -> torch.Tensor:
    """Each query scores its own doc rows. f32[B, N]."""
    qv = torch.zeros(doc_terms.shape, dtype=torch.float32, device=doc_terms.device)
    zero = qv.new_zeros(())
    for l in range(q_terms.shape[-1]):
        match = doc_terms == q_terms[:, l, None, None]
        qv += torch.where(match, q_weights[:, l, None, None].float(), zero)
    return torch.sum(qv * doc_weights.float(), dim=-1)


def sparse_score_blocks_ref(
    doc_terms: torch.Tensor,  # i32[n_docs_pad, Tmax], the index's doc-major store
    doc_weights: torch.Tensor,  # f32[n_docs_pad, Tmax]
    block_ids: torch.Tensor,  # i32[B, nb]
    q_terms: torch.Tensor,  # i32[B, Lq]
    q_weights: torch.Tensor,  # f32[B, Lq] (0 for padding slots)
    *,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,  # i32[n_docs_pad] tombstone bitmap, 0 = dead
    block_live: torch.Tensor | None = None,  # bool[B, nb], False = not scored
) -> torch.Tensor:
    """Scores of the docs of each query's selected blocks, ``f32[B, nb *
    block_size]``: doc ``j * block_size + i`` of row b is store row
    ``block_ids[b, j] * block_size + i``. Pad docs (id >= ``n_live``), dead
    docs and the docs of blocks whose ``block_live`` entry is False score
    ``-inf``."""
    B = block_ids.shape[0]
    docs = block_ids.long()[..., None] * block_size + torch.arange(block_size,
                                                                  device=block_ids.device)
    flat = docs.reshape(B, -1)
    neg_inf = float("-inf")
    scores = sparse_score_batched_ref(doc_terms[flat], doc_weights[flat], q_terms, q_weights)
    scores = torch.where(flat < n_live, scores, neg_inf)
    if live is not None:
        scores = torch.where(live[flat] != 0, scores, neg_inf)
    if block_live is not None:
        scores = torch.where(block_live.repeat_interleave(block_size, dim=1), scores, neg_inf)
    return scores
