"""Plain PyTorch version of the impact-scatter kernel.

It takes the kernel's own input layout (rows sorted by doc, the sentinel
doc ``n_docs`` on slots that carry nothing) and adds each posting into its
doc in row order; on the CPU ``index_add_`` runs sequentially, so the sums
match the kernel's order. The CPU path of ``ops`` uses it, and
``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch


def impact_scatter_batched_ref(
    docs: torch.Tensor, contribs: torch.Tensor, n_docs: int
) -> torch.Tensor:
    """acc[b, d] = sum of contribs[b] whose docs[b] == d, for d < n_docs.

    ``docs`` lie in ``[0, n_docs]``; the sentinel column ``n_docs`` is
    dropped. f32[B, n_docs].
    """
    B = docs.shape[0]
    width = n_docs + 1
    keys = docs.long() + torch.arange(B, device=docs.device)[:, None] * width
    acc = torch.zeros(B * width, dtype=torch.float32, device=docs.device)
    acc.index_add_(0, keys.reshape(-1), contribs.float().reshape(-1))
    return acc.view(B, width)[:, :n_docs]
