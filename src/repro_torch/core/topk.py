"""Top-k utilities with the reference's tie rule.

``jax.lax.top_k`` breaks every tie toward the lowest index, and the
reference's doc-id parity depends on it. ``torch.topk`` does not promise
that order, so every selection here is a stable descending ``torch.sort``
followed by taking the first k: equal scores keep their input order, which
puts the lowest index first, ``-inf`` ties included.

``canonical_topk_merge`` and ``sharded_topk_merge`` arrive with multi-GPU
serving.
"""
from __future__ import annotations

from typing import Tuple

import torch


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k scores and indices (descending, lowest index first on ties)."""
    k = min(k, scores.shape[-1])
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def tiled_topk(
    scores: torch.Tensor, k: int, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage top-k: per-tile top-k then merge.

    The tail tile of a ragged input is padded with ``-inf`` (pad slots sit
    at the highest flat positions, so they sort behind every real entry,
    real ``-inf`` ties included), and ``k`` larger than the tile is clamped
    per tile. Both stay rank-safe. The output width is ``min(k, n)``.
    """
    n = scores.shape[-1]
    tile = -(-n // num_tiles)  # ceil: tail tile may be partial
    n_pad = tile * num_tiles
    if n_pad != n:
        pad = scores.new_full(scores.shape[:-1] + (n_pad - n,), float("-inf"))
        scores = torch.cat([scores, pad], dim=-1)
    k_out = min(k, n)
    k_tile = min(k_out, tile)  # clamped k keeps whole tiles -> merge stays exact
    tiles = scores.reshape(scores.shape[:-1] + (num_tiles, tile))
    s, i = topk(tiles, k_tile)  # [..., num_tiles, k_tile]
    base = (torch.arange(num_tiles, device=scores.device) * tile)[:, None]
    flat_s = s.reshape(scores.shape[:-1] + (num_tiles * k_tile,))
    flat_i = (i + base).reshape(scores.shape[:-1] + (num_tiles * k_tile,))
    ms, mi = topk(flat_s, k_out)
    return ms, torch.gather(flat_i, -1, mi)


def merge_topk(
    scores_a: torch.Tensor,
    ids_a: torch.Tensor,
    scores_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k pools into one (ties: pool a first, then position)."""
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1)
    ms, mi = topk(s, k)
    return ms, torch.gather(i, -1, mi)


def merge_pools_by_id(
    scores_a: torch.Tensor,
    ids_a: torch.Tensor,
    scores_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two candidate pools with ties canonicalized to doc-id order.

    After a stable id-ascending reorder, position order is id order, so the
    stable top-k surfaces tied candidates in ascending-id order, as a top-k
    over one accumulator covering both pools would. Precondition: a live
    document appears in at most one pool.
    """
    s = torch.cat([scores_a, scores_b], dim=-1)
    i = torch.cat([ids_a, ids_b], dim=-1).to(torch.int32)
    order = torch.sort(i, dim=-1, stable=True).indices
    s = torch.gather(s, -1, order)
    i = torch.gather(i, -1, order)
    ms, mi = topk(s, k)
    return ms, torch.gather(i, -1, mi)
