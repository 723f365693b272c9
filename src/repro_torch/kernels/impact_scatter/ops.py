"""Wrappers around the impact-scatter CUDA kernel (``csrc/impact_scatter.cu``).

They pad, sort postings by doc (``sorted_posting_tiles``) and launch the
kernel for CUDA tensors. For CPU tensors, and only for those, they run the
plain PyTorch version in ``ref.py`` instead. There is no fallback: on a
CUDA tensor the kernel runs or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0


def impact_scatter_launch(
    docs: torch.Tensor, contribs: torch.Tensor, n_docs: int, block_d: int
) -> torch.Tensor:
    """Launch the kernel on sorted postings. f32[B, n_docs] on the card.

    ``docs`` i32[B, P] sorted per row with values in ``[0, n_docs]``,
    ``contribs`` f32[B, P]; ``n_docs % block_d == 0``.
    """
    global LAUNCHES
    common.check_block_d(block_d)
    common.check_cuda_tensors(docs, contribs)
    if docs.dtype != torch.int32 or contribs.dtype != torch.float32:
        raise TypeError(f"expected i32 docs and f32 contribs, got {docs.dtype}, {contribs.dtype}")
    if docs.ndim != 2 or docs.shape != contribs.shape:
        raise ValueError(f"expected matching [B, P] inputs, got {docs.shape}, {contribs.shape}")
    if n_docs % block_d:
        raise ValueError(f"n_docs {n_docs} is not a multiple of block_d {block_d}")
    shape = common.scatter_shape(block_d)
    lib = common.kernel_library("impact_scatter")
    fn = lib.impact_scatter_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, P = docs.shape
    out = torch.empty((B, n_docs), dtype=torch.float32, device=docs.device)
    if B and n_docs:
        code = fn(common.ptr(docs), common.ptr(contribs), common.ptr(out),
                  B, P, n_docs, block_d, shape["dpt"], shape["stage"], shape["smem"],
                  common.stream_of(docs))
        common.raise_on_error("impact_scatter", code)
        LAUNCHES += 1
    return out


def impact_scatter_batched(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    *,
    block_d: int = 512,
    tile_p: int = 512,
) -> torch.Tensor:
    """acc[b, d] = sum of contribs[b] with doc_ids[b] == d. f32[B, n_docs].

    ``doc_ids`` entries lie in ``[0, n_docs)``; masked-out postings carry
    contribution 0. One kernel launch covers the whole batch.
    """
    common.check_block_d(block_d)  # the same limits on the CPU as on the card
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    docs, c = common.sorted_posting_tiles(doc_ids, contribs, n_docs_pad, tile_p)
    if docs.device.type == "cpu":
        acc = impact_scatter_batched_ref(docs, c, n_docs_pad)
    else:
        acc = impact_scatter_launch(docs, c, n_docs_pad, block_d)
    return acc[:, :n_docs]


def impact_scatter(
    doc_ids: torch.Tensor,
    contribs: torch.Tensor,
    n_docs: int,
    *,
    block_d: int = 512,
    tile_p: int = 512,
) -> torch.Tensor:
    """Single-query ``[P]`` form: a batch of one. f32[n_docs]."""
    return impact_scatter_batched(
        doc_ids[None], contribs[None], n_docs, block_d=block_d, tile_p=tile_p
    )[0]
