"""Plain PyTorch version of the match-and-accumulate scorer.

``score_d = sum_j w_dj * qv(term_dj)`` with ``qv(t) = sum_l [t == qt_l] * qw_l``
added in slot order, one query slot at a time over the whole ``[B, N, Tmax]``
tile: no ``[..., Lq]`` one-hot is built, so the card holds a main-path tile.
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
