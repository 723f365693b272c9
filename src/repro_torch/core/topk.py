"""Top-k utilities with the reference's tie rule.

``jax.lax.top_k`` breaks every tie toward the lowest index, and the
reference's doc-id parity depends on it. ``torch.topk`` does not promise
that order, so every selection here is a stable descending ``torch.sort``
followed by taking the first k: equal scores keep their input order, which
puts the lowest index first, ``-inf`` ties included.

The two collective merges take, in place of the reference's mesh axis
name, the gather: ``group=None`` for the in-process path, where the pools
are a sequence of every rank's pool in the mesh's flat rank order, or a
``torch.distributed`` process group, where the pool is this rank's own.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Pools = Union[torch.Tensor, Sequence[torch.Tensor]]


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


def gather_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, in group rank
    order: ``[world, *x.shape]`` (``all_gather_into_tensor``)."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group),) + tuple(x.shape))
    dist.all_gather_into_tensor(out.view((-1,) + tuple(x.shape[1:])), x, group=group)
    return out


def _gather_pools(
    scores: Pools, ids: Pools, group: Optional[dist.ProcessGroup] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Every rank's pool concatenated along the last axis, rank-major: what
    the reference's ``all_gather(..., axis=-1, tiled=True)`` returns, and
    the number of ranks.

    ``group=None``: ``scores`` and ``ids`` are sequences of every rank's
    ``[..., k]`` pool in rank order (the in-process path). Otherwise they
    are this rank's pool, gathered over ``group``.
    """
    if group is None:
        return torch.cat(list(scores), dim=-1), torch.cat(list(ids), dim=-1), len(scores)

    def cat(x):
        g = gather_ranks(x, group)  # [R, ..., k]
        return torch.movedim(g, 0, -2).reshape(x.shape[:-1] + (-1,))

    return cat(scores), cat(ids), dist.get_world_size(group)


def sharded_topk_merge(
    local_scores: Pools, local_ids: Pools, k: int,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed top-k: gather every rank's top-k pool and re-select.

    Ties break by pool position (rank-major), which is not the unsharded
    engines' tie order once pad sentinels enter the pool: a sentinel
    ``(-inf, INT32_MAX)`` from an early rank outranks a real ``-inf``
    document from a later one. Serve paths that promise the unsharded
    answer use :func:`canonical_topk_merge`.
    """
    gs, gi, _ = _gather_pools(local_scores, local_ids, group)
    ms, mi = topk(gs, k)
    return ms, torch.gather(gi, -1, mi)


def canonical_topk_merge(
    local_scores: Pools, local_ids: Pools, k: int,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed top-k with ties canonicalized to global-doc-id order.

    The gathered candidates are stably reordered by global doc id, then
    re-selected with :func:`tiled_topk`, one tile per rank. Position order
    is then id order (within a tile directly, across tiles because each
    tile is a contiguous id range), and the selects break ties toward the
    lower position, so tied candidates surface in ascending-id order
    whatever the number of ranks, and pad sentinels (``INT32_MAX``) fall
    behind every real ``-inf`` document: the unsharded engines' answer.
    """
    gs, gi, n_ranks = _gather_pools(local_scores, local_ids, group)
    order = torch.sort(gi, dim=-1, stable=True).indices
    gs = torch.gather(gs, -1, order)
    gi = torch.gather(gi, -1, order)
    ms, mi = tiled_topk(gs, k, num_tiles=max(n_ranks, 1))
    return ms, torch.gather(gi, -1, mi)
