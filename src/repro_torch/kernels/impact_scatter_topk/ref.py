"""Plain PyTorch version of the fused scatter and per-block top-k kernel.

Same input layout as the kernel (rows sorted by doc, sentinel doc
``n_docs`` on slots that carry nothing): the impact-scatter plain version,
the pad and tombstone mask, then each block's top-k with the lowest id
first among equal scores.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref


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
    B = docs.shape[0]
    acc = impact_scatter_batched_ref(docs, contribs, n_docs)
    keep = torch.arange(n_docs, device=acc.device) < n_live
    if live is not None:
        keep = keep & (live != 0)
    acc = torch.where(keep, acc, float("-inf"))
    s, i = topk(acc.view(B, n_docs // block_d, block_d), k)
    base = (torch.arange(n_docs // block_d, device=acc.device) * block_d)[None, :, None]
    return s, (i + base).to(torch.int32)
