"""Plain PyTorch version of the fused DAAT chunk step.

One trip is the batched engine's split-mode phase-2 body: ``topk`` over the
remaining bounds, the live gate ``ub_c > theta``, the plain scorer over the
selected blocks' doc-major rows with pad, tombstoned and non-live docs
masked to ``-inf``, then ``merge_topk`` (pool first) and ``processed |=
live``. The multi-trip version applies trips while ``t < trips_left`` and the
row's highest remaining bound is above theta, as the kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import merge_topk, topk
from repro_torch.kernels.sparse_score.ref import sparse_score_batched_ref


def chunk_step_batched_ref(
    doc_terms: torch.Tensor,  # i32[n_docs_pad, Tmax]
    doc_weights: torch.Tensor,  # f32[n_docs_pad, Tmax]
    q_terms: torch.Tensor,  # i32[B, Lq]
    q_weights: torch.Tensor,  # f32[B, Lq] (weight-0 slots add nothing)
    ub: torch.Tensor,  # f32[B, n_blocks]
    processed: torch.Tensor,  # bool[B, n_blocks]
    pool_s: torch.Tensor,  # f32[B, k]
    pool_i: torch.Tensor,  # i32[B, k]
    theta: torch.Tensor,  # f32[B]
    *,
    block_budget: int,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,  # i32[n_docs_pad] tombstone bitmap, nonzero = live
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One trip; returns ``(pool_s, pool_i, theta, processed)``."""
    B, k = pool_s.shape
    rub = torch.where(processed, float("-inf"), ub)
    ub_c, b_c = topk(rub, block_budget)  # [B, budget]
    live_blk = ub_c > theta[:, None]
    docs = b_c[..., None] * block_size + torch.arange(block_size, device=ub.device)
    flat = docs.reshape(B, -1)
    s = sparse_score_batched_ref(doc_terms[flat], doc_weights[flat], q_terms, q_weights)
    keep = (flat < n_live) & live_blk.repeat_interleave(block_size, dim=1)
    if live is not None:
        keep &= live[flat] != 0
    s = torch.where(keep, s, float("-inf"))
    new_s, new_i = merge_topk(pool_s, pool_i, s, flat.to(torch.int32), k)
    new_processed = processed.scatter(1, b_c, torch.gather(processed, 1, b_c) | live_blk)
    return new_s, new_i, new_s[:, k - 1], new_processed


def chunk_step_multi_batched_ref(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    ub: torch.Tensor,
    processed: torch.Tensor,
    pool_s: torch.Tensor,
    pool_i: torch.Tensor,
    theta: torch.Tensor,
    trips_left: torch.Tensor,  # i32[B] per-row trip budget
    *,
    trips_per_launch: int,
    block_budget: int,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``trips_per_launch`` gated trips; returns the state and
    ``trips_done i32[B]``."""
    trips_done = torch.zeros(trips_left.shape, dtype=torch.int32, device=ub.device)
    for t in range(trips_per_launch):
        rub = torch.where(processed, float("-inf"), ub)
        act = (t < trips_left) & (rub.amax(dim=-1) > theta)
        ns, ni, nth, npr = chunk_step_batched_ref(
            doc_terms, doc_weights, q_terms, q_weights, ub, processed, pool_s, pool_i, theta,
            block_budget=block_budget, block_size=block_size, n_live=n_live, live=live,
        )
        pool_s = torch.where(act[:, None], ns, pool_s)
        pool_i = torch.where(act[:, None], ni, pool_i)
        theta = torch.where(act, nth, theta)
        processed = torch.where(act[:, None], npr, processed)
        trips_done += act.to(torch.int32)
    return pool_s, pool_i, theta, processed, trips_done
