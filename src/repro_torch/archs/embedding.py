"""EmbeddingBag and sparse-feature tables: the port of
``repro.archs.embedding``.

  * one **concatenated table** ``[total_rows, dim]`` per model with per-slot
    row offsets;
  * ``embedding_lookup``: fixed-slot features (one id per slot), a gather;
  * ``embedding_bag``: ragged multi-hot features, a gather and an
    ``index_add_`` (sum/mean combiners), the pattern the GNN's message
    passing shares;
  * hashed OOV folding, so synthetic id streams can exceed table sizes.

``fold_ids`` keeps the reference's int32 arithmetic (``% rows + offset``);
indices are cast to int64 only to index.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.archs import layers


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static layout of a model's concatenated embedding table."""

    slot_rows: tuple[int, ...]  # rows per feature slot
    dim: int

    @property
    def n_slots(self) -> int:
        return len(self.slot_rows)

    @property
    def total_rows(self) -> int:
        return int(sum(self.slot_rows))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.slot_rows)[:-1]]).astype(np.int64)

    def nbytes(self, dtype_bytes: int = 4) -> int:
        return self.total_rows * self.dim * dtype_bytes


def init_table(gen: torch.Generator | None, spec: TableSpec, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return layers.embed_init(gen, spec.total_rows, spec.dim, dtype, device)


def fold_ids(ids: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Per-slot modulo fold + offset into the concatenated table.

    ``ids: i32[..., n_slots]`` raw per-slot ids (any magnitude) -> global
    row indices (int32) into the ``[total_rows, dim]`` table.
    """
    rows = torch.as_tensor(spec.slot_rows, dtype=torch.int32, device=ids.device)
    offs = torch.as_tensor(spec.offsets, dtype=torch.int32, device=ids.device)
    return torch.remainder(ids.to(torch.int32), rows) + offs


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, spec: TableSpec) -> torch.Tensor:
    """Fixed-slot lookup: ``ids [..., n_slots] -> [..., n_slots, dim]``."""
    return table[fold_ids(ids, spec).long()]


def embedding_bag(
    table: torch.Tensor,
    flat_ids: torch.Tensor,  # i32[nnz] global row indices (already folded)
    segment_ids: torch.Tensor,  # i32[nnz] output bag per id
    num_segments: int,
    *,
    weights: torch.Tensor | None = None,  # f32[nnz]
    combiner: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag: ``out[b] = combine_{i: seg[i]==b} w_i * table[id_i]``."""
    vecs = table[flat_ids.long()]
    if weights is not None:
        vecs = vecs * weights[:, None].to(vecs.dtype)
    seg = segment_ids.long()
    s = vecs.new_zeros((num_segments, vecs.shape[1])).index_add(0, seg, vecs)
    if combiner == "sum":
        return s
    if combiner == "mean":
        ones = vecs.new_ones((flat_ids.shape[0], 1))
        if weights is not None:
            ones = weights[:, None].to(vecs.dtype)
        cnt = vecs.new_zeros((num_segments, 1)).index_add(0, seg, ones)
        return s / torch.clamp(cnt, min=1e-9)
    raise ValueError(combiner)


def masked_mean_bag(vecs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dense-layout bag: ``vecs [B, L, D]`` + ``mask [B, L]`` -> mean [B, D]."""
    m = mask.to(vecs.dtype)[..., None]
    return (vecs * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1e-9)


def criteo_like_rows(n_slots: int, *, big: int, medium: int, small: int,
                     seed: int = 0) -> tuple[int, ...]:
    """A realistic skewed slot-size mix (a few huge id spaces, many small).

    Sizes round to multiples of 1024 so the concatenated table's row axis
    shards evenly over every production mesh (256- and 512-chip).
    """
    rng = np.random.default_rng(seed)
    sizes = []
    for i in range(n_slots):
        if i < max(1, n_slots // 8):
            sizes.append(big)
        elif i < n_slots // 2:
            sizes.append(medium)
        else:
            sizes.append(small)
    return tuple(max(1024, int(s * (0.5 + rng.random())) // 1024 * 1024) for s in sizes)
