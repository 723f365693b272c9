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

``CONTRACT`` declares the shapes the kernel is checked at and its launch
plan (:func:`launch_plan`, which the launcher takes its numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.kernels import common
from repro_torch.kernels.block_prune_csr.ref import block_prune_csr_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# Blocks a CTA: the tile that chip_smoke.py's sweep found fastest on the
# engine's [64, 35, 2159] batch (PERF.md).
PRUNE_TILE = 128
# Threads of a CTA (THREADS in the kernel).
THREADS = 256
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


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, n_bm: int, lq: int, n_blocks: int,
                tile: int = PRUNE_TILE) -> common.LaunchPlan:
    """The kernel's launch: a CTA a (tile of blocks, query), with
    ``prune_csr_layout``'s shared memory."""
    lay = prune_csr_layout(lq, n_blocks, tile)
    g = lay["group"]
    return common.LaunchPlan(
        "block_prune_csr", "block_prune_csr_launch", "block_prune_csr_kernel",
        (batch, n_bm, lq, n_blocks, tile, g), grid=(lay["tiles"], batch, 1), threads=THREADS,
        smem=((f"dense tile f32[{g}, {tile}]", 4 * g * tile), (f"bounds f32[{tile}]", 4 * tile),
              (f"slot weights f32[{g}]", 4 * g), (f"sub-windows i32[3 x {g} + 1]", 4 * (3 * g + 1))),
        cover=(("x", n_blocks, tile), ("y", batch, 1)))


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
    plan = launch_plan(B, bm_block.shape[0], lq, n_blocks, tile)
    ub = torch.empty((B, n_blocks), dtype=torch.float32, device=base.device)
    survive = torch.empty((B, n_blocks), dtype=torch.bool, device=base.device)
    if B and n_blocks:
        ptrs = tuple(t.data_ptr() for t in (bm_block, bm_weight, base, cnt, q_weights, theta,
                                              ub, survive))
        common.launch("block_prune_csr", plan.symbol, 8, ptrs + plan.ints, base.get_device())
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
    return common.run_kernel(
        "block_prune_csr", (*base.shape, args[0].shape[0], n_blocks), base,
        lambda: block_prune_csr_batched_ref(*args, n_blocks=n_blocks, max_bm_per_term=m),
        lambda: block_prune_csr_launch(*args, n_blocks))


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    return [launch_plan(dims["batch"], dims["n_bm"], dims["lq"], dims["nb"])]


def _contract_call(dims, device):
    """The wrapper at ``dims`` on CSR lists of random terms (each list's
    blocks distinct and ascending, up to ``2 m`` of them) and windows into
    them, a fifth of them (or ``dims["empty"]``) empty pad slots; one row
    with theta = -inf."""
    rng = np.random.default_rng(dims["n_bm"] + dims["lq"])
    nb, m, n_bm = dims["nb"], dims["m"], dims["n_bm"]
    bm_block = np.zeros(n_bm, np.int32)
    starts, counts, total = [], [], 0
    while True:
        c = int(min(rng.integers(1, 2 * m + 1), nb))
        if total + c > n_bm:
            break
        bm_block[total:total + c] = np.sort(rng.choice(nb, c, replace=False))
        starts.append(total)
        counts.append(c)
        total += c
    bm_weight = np.zeros(n_bm, np.float32)
    bm_weight[:total] = rng.gamma(1.0, 1.0, total)
    terms = rng.integers(0, len(starts), (dims["batch"], dims["lq"]))
    base = np.asarray(starts, np.int32)[terms]
    cnt = np.asarray(counts, np.int32)[terms]
    qw = rng.gamma(1.0, 1.0, terms.shape).astype(np.float32)
    empty = rng.random(terms.shape) < dims.get("empty", 0.2)
    base[empty], cnt[empty], qw[empty] = total, 0, 0.0
    theta = rng.uniform(0.0, 2.0, dims["batch"]).astype(np.float32)
    theta[0] = -np.inf
    args = tuple(torch.as_tensor(a, device=device)
                 for a in (bm_block, bm_weight, base, cnt, qw, theta))
    return functools.partial(block_prune_csr_batched, n_blocks=nb, max_bm_per_term=m), args


# The reference contract's cases (same names and dims), then the edges
# chip_smoke.py holds the kernel to (prune_inputs): lists holding the blocks
# on both sides of every boundary of 32-block tiles, the engine's widths
# (Lq 35, 2,159 blocks) at B = 64, 63 and 1, NB not a multiple of the tile,
# a window cut at the end of the lists, all pad slots, one block.
CONTRACT = KernelContract(
    name="block_prune_csr",
    description="CSR-walking block upper-bound + prune (DAAT phase 0, no densify)",
    make_call=_contract_call,
    plan=_contract_plan,
    shape_grid=(
        ShapeCase("b1", dict(batch=1, lq=8, nb=100, m=16, n_bm=800)),
        ShapeCase("b4_wide", dict(batch=4, lq=32, nb=2048, m=64, n_bm=12000)),
        ShapeCase("b3_tiny", dict(batch=3, lq=5, nb=17, m=3, n_bm=40)),
        ShapeCase("b2_single_slot", dict(batch=2, lq=1, nb=64, m=8, n_bm=100)),
        ShapeCase("edges_b64_lq35_nb2159",
                  dict(batch=64, lq=35, nb=2159, m=900, n_bm=40000, edge_tile=32), port=True),
        ShapeCase("edges_b63_lq35_nb2159",
                  dict(batch=63, lq=35, nb=2159, m=900, n_bm=40000, edge_tile=32), port=True),
        ShapeCase("edges_b1_lq35_nb2159",
                  dict(batch=1, lq=35, nb=2159, m=900, n_bm=40000, edge_tile=32), port=True),
        ShapeCase("ragged_b3_lq9_nb300",
                  dict(batch=3, lq=9, nb=300, m=60, n_bm=1200, edge_tile=32), port=True),
        ShapeCase("cut_at_end_b2_lq5", dict(batch=2, lq=5, nb=200, m=30, n_bm=400, cut=1),
                  port=True),
        ShapeCase("all_pad_b4_lq8", dict(batch=4, lq=8, nb=2159, m=100, n_bm=2000, empty=1.0),
                  port=True),
        ShapeCase("one_block_b2", dict(batch=2, lq=3, nb=1, m=1, n_bm=10), port=True),
    ),
)
