"""Plain PyTorch version of the CSR block-prune kernel.

The masked gather of each (query, slot) window of the CSR block-max lists,
then one scatter-add of ``qw * bm_weight`` into ``[B, n_blocks]`` in
(query, slot, entry) order: every bound is summed slot by slot, as the
kernel and the reference's jnp scatter-add sum it, so on the CPU, where
``index_add_`` runs sequentially, ``ub`` is equal to both bit for bit.
"""
from __future__ import annotations

import torch


def block_prune_csr_batched_ref(
    bm_block: torch.Tensor,
    bm_weight: torch.Tensor,
    base: torch.Tensor,
    cnt: torch.Tensor,
    q_weights: torch.Tensor,
    theta: torch.Tensor,
    *,
    n_blocks: int,
    max_bm_per_term: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ub f32[B, n_blocks], survive bool[B, n_blocks])``.

    Slot ``l`` of query ``b`` reads entries ``[base, base + min(cnt, M))``,
    cut at the end of the lists; ``survive = (ub > theta) & (ub > 0)``.
    """
    B, lq = base.shape
    dev = base.device
    offs = torch.arange(max_bm_per_term, dtype=torch.int32, device=dev)
    idx = base[..., None] + offs  # [B, Lq, M]
    valid = (offs < torch.clamp_max(cnt, max_bm_per_term)[..., None]) & (idx < bm_block.shape[0])
    idx = torch.where(valid, idx, 0).long()
    blocks = torch.where(valid, bm_block[idx], 0).long()
    w = torch.where(valid, bm_weight[idx], 0.0) * q_weights.float()[..., None]
    keys = blocks + torch.arange(B, device=dev)[:, None, None] * n_blocks
    ub = torch.zeros(B * n_blocks, dtype=torch.float32, device=dev)
    ub.index_add_(0, keys.reshape(-1), w.reshape(-1))
    ub = ub.view(B, n_blocks)
    survive = (ub > theta.float()[:, None]) & (ub > 0)
    return ub, survive
