"""Plain PyTorch versions of the fused scatter and per-block top-k kernels.

``impact_scatter_topk_block_ref`` takes the ``[B, P]`` entry's input layout
(rows sorted by doc, sentinel doc ``n_docs`` on slots that carry nothing):
the impact-scatter plain version, the pad and tombstone mask, then each
block's top-k with the lowest id first among equal scores.

``impact_scatter_topk_segments_ref`` takes the segment entry's: the posting
store and a SAAT plan. It walks each row's admitted plan columns in plan
order and adds each column's postings into the row's accumulator, one
``index_add_`` a column. A column is one segment of the index, which holds
a doc at most once, so every doc's terms are added one at a time in plan
order, the order the stable doc sort of the gathered route keeps: the sums
have the same bits. It neither gathers a ``[B, rho]`` array nor sorts one,
so the tests can hold it against the route it replaces.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref


def block_candidates(
    acc: torch.Tensor, n_live: int, k: int, block_d: int, live: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each block's top-k of ``acc`` f32[B, n_docs] with ids ``>= n_live``
    and ids with ``live == 0`` masked to ``-inf``:
    ``(f32, i32)[B, n_docs // block_d, k]``."""
    B, n_docs = acc.shape
    keep = torch.arange(n_docs, device=acc.device) < n_live
    if live is not None:
        keep = keep & (live != 0)
    acc = torch.where(keep, acc, float("-inf"))
    s, i = topk(acc.view(B, n_docs // block_d, block_d), k)
    base = (torch.arange(n_docs // block_d, device=acc.device) * block_d)[None, :, None]
    return s, (i + base).to(torch.int32)


def impact_scatter_topk_block_ref(
    docs: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    n_live: int,
    k: int,
    block_d: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block candidates ``(f32, i32)[B, n_docs // block_d, k]``.

    ``n_docs % block_d == 0``; ids ``>= n_live`` and ids with ``live == 0``
    score ``-inf``.
    """
    return block_candidates(impact_scatter_batched_ref(docs, contribs, n_docs), n_live, k,
                            block_d, live)


def segment_sums_ref(
    doc_ids: torch.Tensor,
    starts: torch.Tensor,
    contribs: torch.Tensor,
    cum_len: torch.Tensor,
    rho: int,
    n_docs: int,
) -> torch.Tensor:
    """acc[b, d]: the contributions of row b's first ``min(rho, total)``
    plan postings whose doc is d, added in plan order. f32[B, n_docs]."""
    B, C = cum_len.shape
    cum = cum_len.long()
    prev = torch.nn.functional.pad(cum[:, :-1], (1, 0))
    limit = torch.clamp_max(cum[:, -1:], rho)
    take = torch.clamp_min(torch.minimum(cum, limit) - prev, 0)  # admitted postings a column
    acc = torch.zeros(B * n_docs, dtype=torch.float32, device=cum_len.device)
    rows = torch.arange(B, device=cum_len.device)
    for j in torch.nonzero(take.any(0)).flatten().tolist():
        n = take[:, j]
        row = torch.repeat_interleave(rows, n)
        first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
        pos = starts[row, j].long() + torch.arange(row.numel(), device=row.device) - first
        acc.index_add_(0, row * n_docs + doc_ids[pos].long(), contribs[row, j].float())
    return acc.view(B, n_docs)


def impact_scatter_topk_segments_ref(
    doc_ids: torch.Tensor,
    starts: torch.Tensor,
    contribs: torch.Tensor,
    cum_len: torch.Tensor,
    rho: int,
    n_docs: int,
    n_live: int,
    k: int,
    block_d: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The segment entry's per-block candidates, ``(f32, i32)[B, n_docs //
    block_d, k]``, from :func:`segment_sums_ref` and :func:`block_candidates`."""
    acc = segment_sums_ref(doc_ids, starts, contribs, cum_len, rho, n_docs)
    return block_candidates(acc, n_live, k, block_d, live)
