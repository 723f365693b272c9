"""Wrapper around the CSR block-prune CUDA kernel (``csrc/block_prune_csr.cu``).

For CPU tensors, and only for those, it runs the plain version in
``ref.py`` in place of the kernel. On a CUDA tensor the kernel runs or the
call raises. Unlike the reference's wrapper it appends no pad behind the
CSR lists and pads no block axis: the kernel cuts each window at the end
of the lists and masks its own ragged tile.

Precondition of the kernel (not of the plain version): within each window
the block ids are distinct, ascend and lie in ``[0, n_blocks)``. Every
index builder of the port gives that (the block-max lists come from
``np.unique`` over ``term * n_blocks + block``).
A CTA owns a (query, tile of ``tile`` blocks) and finds each slot's entries
of its tile by a search of the window (:func:`prune_csr_layout`).
"""
from __future__ import annotations


import torch

from repro_torch.kernels import common
from repro_torch.kernels.block_prune_csr.ref import block_prune_csr_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# Blocks a CTA: the tile that chip_smoke.py's sweep found fastest on the
# engine's [64, 35, 2159] batch (PERF.md).
PRUNE_TILE = 128
# Cells of a CTA's dense [group, tile] tile of products (40 KB of shared
# memory): a round takes group = DENSE_CELLS // tile slots, at most Lq.
DENSE_CELLS = 10_240


def prune_csr_layout(lq: int, n_blocks: int, tile: int = PRUNE_TILE) -> dict:
    """The kernel's launch shape: ``tile`` blocks a CTA, ``tiles`` CTAs a
    query, ``group`` slots a round of the dense tile (``rounds`` rounds),
    and the shared memory (bytes) of the dense tile, the bounds and the slot
    descriptors."""
    if not 1 <= tile <= DENSE_CELLS:
        raise ValueError(f"tile={tile} must be in [1, {DENSE_CELLS}]")
    group = max(1, min(lq, DENSE_CELLS // tile))
    return dict(tile=tile, tiles=-(-n_blocks // tile), group=group, rounds=-(-lq // group),
                smem=4 * (group * tile + tile + 4 * group + 1))


def block_prune_csr_launch(
    bm_block: torch.Tensor,
    bm_weight: torch.Tensor,
    base: torch.Tensor,
    cnt: torch.Tensor,
    q_weights: torch.Tensor,
    theta: torch.Tensor,
    n_blocks: int,
    tile: int = PRUNE_TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(ub f32, survive bool)[B, n_blocks]``.

    ``bm_block`` i32 / ``bm_weight`` f32 ``[n_bm]`` (block ids distinct,
    ascending and in ``[0, n_blocks)`` within each window), ``base``/``cnt``
    i32 and ``q_weights`` f32 ``[B, Lq]`` (counts already clamped),
    ``theta`` f32[B]; ``tile`` blocks a CTA.
    """
    global LAUNCHES
    common.check_cuda_tensors(bm_block, bm_weight, base, cnt, q_weights, theta)
    common.check_dtypes(bm_block=(bm_block, torch.int32), bm_weight=(bm_weight, torch.float32),
                        base=(base, torch.int32), cnt=(cnt, torch.int32),
                        q_weights=(q_weights, torch.float32), theta=(theta, torch.float32))
    B, lq = base.shape
    if cnt.shape != (B, lq) or q_weights.shape != (B, lq) or theta.shape != (B,):
        raise ValueError("base, cnt and q_weights must be [B, Lq] and theta [B]")
    if bm_block.ndim != 1 or bm_weight.shape != bm_block.shape:
        raise ValueError("bm_block and bm_weight must be matching 1-D lists")
    layout = prune_csr_layout(lq, n_blocks, tile)
    ub = torch.empty((B, n_blocks), dtype=torch.float32, device=base.device)
    survive = torch.empty((B, n_blocks), dtype=torch.bool, device=base.device)
    if B and n_blocks:
        ptrs = tuple(t.data_ptr() for t in (bm_block, bm_weight, base, cnt, q_weights, theta,
                                              ub, survive))
        common.launch("block_prune_csr", "block_prune_csr_launch", 8,
                      ptrs + (B, bm_block.shape[0], lq, n_blocks, tile, layout["group"]),
                      base.get_device())
        LAUNCHES += 1
    return ub, survive


def block_prune_csr_batched(
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
    """Batched ``(ub f32[B, n_blocks], survive bool[B, n_blocks])`` straight
    off the CSR block-max lists.

    ``base``/``cnt``: ``i32[B, Lq]`` window starts and entry counts
    (:func:`repro_torch.core.daat.csr_blockmax_offsets`); counts clamp to
    ``max_bm_per_term``. ``q_weights``: ``f32[B, Lq]``. ``theta``: ``f32[B]``
    thresholds (``-inf`` for a pure bound pass). The kernel needs the block
    ids distinct and ascending within each window, as every index of the
    port has them.
    """
    m = max_bm_per_term
    if m < 1:
        raise ValueError(f"max_bm_per_term={m} must be >= 1")
    args = (
        bm_block.to(torch.int32).contiguous(),
        bm_weight.to(torch.float32).contiguous(),
        base.to(torch.int32).contiguous(),
        torch.clamp_max(cnt.to(torch.int32), m).contiguous(),
        q_weights.to(torch.float32).contiguous(),
        torch.as_tensor(theta, dtype=torch.float32, device=base.device).contiguous(),
    )
    if base.device.type == "cpu":
        return block_prune_csr_batched_ref(*args, n_blocks=n_blocks, max_bm_per_term=m)
    return block_prune_csr_launch(*args, n_blocks)
