"""Wrappers around the impact-scatter CUDA kernel (``csrc/impact_scatter.cu``).

They pad, sort postings by doc (``sorted_posting_tiles``) and launch the
kernel for CUDA tensors. For CPU tensors, and only for those, they run the
plain PyTorch version in ``ref.py`` instead. There is no fallback: on a
CUDA tensor the kernel runs or the call raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# The kernel (``csrc/impact_scatter.cu``) cuts each row into ranges of
# THREADS * spt posting slots, spt one of SLOTS_PER_THREAD (a warp takes 32
# * spt of them, a lane spt), and gives a CTA ``stages`` consecutive ranges,
# one staged in shared memory while the one before it is summed. A range
# also stages the EXTRA slots after it, for a run that goes on past its end
# (a longer run reads on one slot a load).
THREADS = 256
SLOTS_PER_THREAD = (2, 4, 8)
STAGES = (1, 2, 4, 8, 16, 32)
EXTRA = 64
# CTAs an SM should get from a batch before a CTA takes more ranges.
CTAS_PER_SM = 56


@functools.lru_cache(maxsize=256)
def range_layout(batch: int, n_slots: int, n_docs: int, n_sms: int) -> tuple[int, int]:
    """``(spt, stages)`` for ``[batch, n_slots]`` slots over ``n_docs`` docs.

    spt follows the slots a doc: the least of ``SLOTS_PER_THREAD`` at or
    above ``n_slots / n_docs`` (the most where none is). Dense rows (rho =
    1M on the 276,307-doc shard: 3.6 slots a doc) take longer lanes; sparse
    ones (100k: 0.36) more, shorter units, whose warps share the writing
    of the wide doc spans between postings. Then the most ranges a CTA that
    still gives every SM ``CTAS_PER_SM`` CTAs (one where none does). Both
    rules are the fastest of ``chip_smoke.py``'s sweep at B = 1 and 64, rho
    = 1M and 100k (``PERF.md``)."""
    spt = next((s for s in SLOTS_PER_THREAD if s * n_docs >= n_slots), SLOTS_PER_THREAD[-1])
    n_ranges = -(-n_slots // (THREADS * spt))
    stages = STAGES[0]
    for k in STAGES:
        if max(batch, 1) * -(-n_ranges // k) >= CTAS_PER_SM * n_sms:
            stages = k
    return spt, stages


def impact_scatter_launch(
    docs: torch.Tensor, contribs: torch.Tensor, n_docs: int, block_d: int
) -> torch.Tensor:
    """Launch the kernel on sorted postings. f32[B, n_docs] on the card.

    ``docs`` i32[B, P] sorted per row with values in ``[0, n_docs]`` (the
    sentinel ``n_docs`` on slots that carry nothing), ``contribs``
    f32[B, P]; ``n_docs % block_d == 0``.
    """
    global LAUNCHES
    common.check_block_d(block_d)
    common.check_cuda_tensors(docs, contribs)
    common.check_dtypes(docs=(docs, torch.int32), contribs=(contribs, torch.float32))
    if docs.ndim != 2 or docs.shape != contribs.shape:
        raise ValueError(f"expected matching [B, P] inputs, got {docs.shape}, {contribs.shape}")
    if n_docs % block_d:
        raise ValueError(f"n_docs {n_docs} is not a multiple of block_d {block_d}")
    B, P = docs.shape
    if B > 65535:
        raise ValueError(f"the kernel takes B <= 65535, got {B}")
    out = contribs.new_empty((B, n_docs))
    if B and n_docs:
        spt, stages = range_layout(B, P, n_docs, common.sm_count(docs.get_device()))
        common.launch("impact_scatter", "impact_scatter_launch", 3,
                      (docs.data_ptr(), contribs.data_ptr(), out.data_ptr(), B, P, n_docs, spt,
                       stages), docs.get_device())
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
