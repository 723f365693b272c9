"""Plain PyTorch version of the dense block-prune kernel.

``ub`` is summed one query slot at a time from 0, a multiply and then an
add per slot, as the kernel sums it: so ``ub`` equals the kernel's bit for
bit, and the CSR kernel's on rows densified from the same lists (a slot
that lists no entry for a block adds exactly 0 there).
"""
from __future__ import annotations

import torch


def block_prune_batched_ref(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``blockmax f32[B, Lq, NB]``, ``q_weights f32[B, Lq]``, ``theta f32[B]``
    -> ``(ub f32[B, NB], survive bool[B, NB])``, ``survive = (ub > theta) &
    (ub > 0)``."""
    B, lq, nb = blockmax.shape
    ub = torch.zeros((B, nb), dtype=torch.float32, device=blockmax.device)
    for l in range(lq):
        ub = ub + q_weights[:, l, None] * blockmax[:, l]
    survive = (ub > theta[:, None]) & (ub > 0)
    return ub, survive
