"""Wrappers around the fused scatter and per-block top-k CUDA kernel
(``csrc/impact_scatter_topk.cu``).

The full fused selection is kernel + merge: the kernel emits per-block
candidate pools ``[B, n_blocks, k_blk]``, and ``tiled_topk`` over the pool
recovers the exact global top-k, with the same ids, ``-inf`` tie order
included, as a top-k over the dense masked accumulator. The merge stays in
plain PyTorch, as the reference keeps it outside Pallas.

For CPU tensors, and only for those, the wrappers run the plain version in
``ref.py`` in place of the kernel. On a CUDA tensor the kernel runs or the
call raises.
"""
from __future__ import annotations


import torch

from repro_torch.core.topk import tiled_topk
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter_topk.ref import impact_scatter_topk_block_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# The largest k_blk whose block top-k the kernel keeps by the select; past
# it, k rounds of a warp-wide max cost more than one bitonic sort of the
# block's keys.
SELECT_MAX_K = 32


def use_select(k_blk: int) -> bool:
    """Whether the kernel keeps a block's ``k_blk`` best by
    ``block_select_desc`` (``select_common.cuh``: k rounds of a warp-wide
    max, then a merge of the warps' lists) rather than a bitonic sort of all
    its keys. Keys are unique, so both give the same ids."""
    return k_blk <= SELECT_MAX_K


def impact_scatter_topk_layout(block_d: int, k_blk: int) -> dict:
    """The kernel's launch shape: the accumulation's (``common.scatter_shape``),
    the select or the sort, its keys (the warps' select lists of
    ``min(k_blk, 32 x dpt)`` keys each, or one key per doc for the sort) and
    its dynamic shared memory: the keys, the block's scores and the
    accumulation's."""
    shape = common.scatter_shape(block_d)
    select = use_select(k_blk)
    list_len = min(k_blk, 32 * shape["dpt"])
    n_keys = (shape["threads"] // 32) * list_len if select else block_d
    return dict(shape, select=select, list_len=list_len, n_keys=n_keys,
                smem=8 * n_keys + 4 * block_d + shape["smem"])


def impact_scatter_topk_launch(
    docs: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    n_live: int,
    k: int,
    block_d: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on sorted postings: ``(f32, i32)[B, n_docs // block_d, k]``.

    ``docs`` i32[B, P] sorted per row with values in ``[0, n_docs]``,
    ``contribs`` f32[B, P], ``live`` optional i32[n_docs];
    ``n_docs % block_d == 0`` and ``0 < k <= block_d``.
    """
    global LAUNCHES
    common.check_block_d(block_d)
    args = (docs, contribs) if live is None else (docs, contribs, live)
    common.check_cuda_tensors(*args)
    if docs.dtype != torch.int32 or contribs.dtype != torch.float32:
        raise TypeError(f"expected i32 docs and f32 contribs, got {docs.dtype}, {contribs.dtype}")
    if docs.ndim != 2 or docs.shape != contribs.shape:
        raise ValueError(f"expected matching [B, P] inputs, got {docs.shape}, {contribs.shape}")
    if n_docs % block_d:
        raise ValueError(f"n_docs {n_docs} is not a multiple of block_d {block_d}")
    if not 0 < k <= block_d:
        raise ValueError(f"k must lie in (0, block_d={block_d}], got {k}")
    if live is not None and (live.dtype != torch.int32 or live.shape != (n_docs,)):
        raise ValueError(f"live must be i32[{n_docs}], got {live.dtype}{list(live.shape)}")
    lay = impact_scatter_topk_layout(block_d, k)
    B, P = docs.shape
    nb = n_docs // block_d
    out_s = torch.empty((B, nb, k), dtype=torch.float32, device=docs.device)
    out_i = torch.empty((B, nb, k), dtype=torch.int32, device=docs.device)
    if B and nb:
        common.launch("impact_scatter_topk", "impact_scatter_topk_launch", 5,
                      (docs.data_ptr(), contribs.data_ptr(),
                       None if live is None else live.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                       B, P, n_docs, n_live, block_d, k, lay["dpt"], lay["stage"],
                       int(lay["select"]), lay["n_keys"], lay["list_len"], lay["smem"]),
                      docs.get_device())
        LAUNCHES += 1
    return out_s, out_i


def _merge_pool(
    cand_s: torch.Tensor, cand_i: torch.Tensor, k_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over per-block pools ``[..., nb, kb]``: one tile
    per block, each tile a block's full candidate set."""
    nb, kb = cand_s.shape[-2:]
    flat_s = cand_s.reshape(cand_s.shape[:-2] + (nb * kb,))
    flat_i = cand_i.reshape(cand_i.shape[:-2] + (nb * kb,))
    ms, mpos = tiled_topk(flat_s, k_out, num_tiles=nb)
    return ms, torch.gather(flat_i, -1, mpos)


def impact_scatter_topk_batched(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    k: int,
    *,
    n_live: int | None = None,
    live: torch.Tensor | None = None,
    block_d: int = 512,
    tile_p: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the masked scatter accumulator, per query: ``[B, min(k, n_docs)]``.

    Ids ``>= n_live`` (default ``n_docs``) and ids whose ``live`` entry is 0
    (an optional i32/bool tombstone bitmap shared by the batch) score
    ``-inf``. The accumulator never reaches device memory.
    """
    common.check_block_d(block_d)  # the same limits on the CPU as on the card
    if n_live is None:
        n_live = n_docs
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    k_out = min(k, n_docs)
    k_blk = min(k_out, block_d)  # a block holds at most block_d of the top-k
    docs, c = common.sorted_posting_tiles(doc_ids, contribs, n_docs_pad, tile_p)
    if live is not None:
        live = common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()
    n_live = min(n_live, n_docs)
    if docs.device.type == "cpu":
        cand_s, cand_i = impact_scatter_topk_block_ref(
            docs, c, n_docs_pad, n_live, k_blk, block_d, live
        )
    else:
        cand_s, cand_i = impact_scatter_topk_launch(
            docs, c, n_docs_pad, n_live, k_blk, block_d, live
        )
    return _merge_pool(cand_s, cand_i, k_out)


def impact_scatter_topk(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    k: int,
    *,
    n_live: int | None = None,
    live: torch.Tensor | None = None,
    block_d: int = 512,
    tile_p: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-query ``[P]`` form: a batch of one. ``[min(k, n_docs)]``."""
    s, i = impact_scatter_topk_batched(
        doc_ids[None], contribs[None], n_docs, k,
        n_live=n_live, live=live, block_d=block_d, tile_p=tile_p,
    )
    return s[0], i[0]
