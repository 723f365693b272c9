"""Plain PyTorch version of the per-tile top-k kernel (stage 1 of the
two-stage top-k): ``topk`` over each tile, the lowest index first among
equal scores, ``-inf`` included, with ids offset by the tile start.
"""
from __future__ import annotations

import torch

from repro_torch.core.topk import topk


def block_topk_stage1_ref(
    scores: torch.Tensor, k: int, tile: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``scores f32[B, n]`` with ``n % tile == 0`` -> ``(f32, i32)[B, n // tile, k]``."""
    B, n = scores.shape
    s, i = topk(scores.view(B, n // tile, tile), k)
    base = (torch.arange(n // tile, device=scores.device) * tile)[None, :, None]
    return s, (i + base).to(torch.int32)
