"""Wrappers around the dense block-prune CUDA kernel (``csrc/block_prune.cu``).

The engine's phase 0 runs off the CSR lists (``block_prune_csr``); this
kernel takes the dense ``[B, Lq, NB]`` block maxima that
:func:`repro_torch.core.daat._dense_blockmax_rows` builds, and serves as
the CSR kernel's oracle, as in the reference. The kernel masks its own
ragged tile, so unlike the reference's wrapper these pad no block axis.

For CPU tensors, and only for those, they run the plain version in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.

``CONTRACT`` declares the shapes the kernel is checked at and its launch
plan (:func:`launch_plan`, which the launcher takes its numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.kernels import common
from repro_torch.kernels.block_prune.ref import block_prune_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# Blocks a CTA sums (TILE in the kernel): the tiles the kernel takes, and
# the wrapper's, the fastest at B = 1 and at B = 64 of the main path's
# [B, 35, 2159] bounds (chip_smoke.py sweeps them; PERF.md).
TILES = (32, 64, 128, 256)
PRUNE_TILE = 64
# Block maxima a CTA holds in shared memory at once (SLAB in the kernel).
SLAB = 8192


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, lq: int, nb: int, tile: int) -> common.LaunchPlan:
    """The kernel's launch: a CTA a (tile of blocks, query), a thread a
    block, a slab of ``SLAB // tile`` slots staged at once."""
    slots = min(lq, SLAB // tile)
    return common.LaunchPlan(
        "block_prune", "block_prune_launch", f"block_prune_kernel<{tile}>", (batch, lq, nb, tile),
        grid=(-(-nb // tile), batch, 1), threads=tile,
        smem=((f"block maxima f32[{slots}, {tile}]", 4 * slots * tile),
              (f"slot weights f32[{slots}]", 4 * slots)),
        cover=(("x", nb, tile), ("y", batch, 1)))


def block_prune_launch(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta: torch.Tensor,
    tile: int = PRUNE_TILE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``blockmax f32[B, Lq, NB]``, ``q_weights f32[B, Lq]``,
    ``theta f32[B]`` -> ``(ub f32, survive bool)[B, NB]``. ``tile``: blocks a
    CTA, one of ``TILES``."""
    global LAUNCHES
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    common.check_cuda_tensors(blockmax, q_weights, theta)
    common.check_dtypes(blockmax=(blockmax, torch.float32), q_weights=(q_weights, torch.float32),
                        theta=(theta, torch.float32))
    B, lq, nb = blockmax.shape
    if q_weights.shape != (B, lq) or theta.shape != (B,):
        raise ValueError("q_weights must be [B, Lq] and theta [B] for blockmax [B, Lq, NB]")
    if B > 65535:
        raise ValueError(f"the kernel takes B <= 65535, got {B}")
    ub = blockmax.new_empty((B, nb))
    survive = blockmax.new_empty((B, nb), dtype=torch.bool)
    if B and nb:
        plan = launch_plan(B, lq, nb, tile)
        common.launch("block_prune", plan.symbol, 5,
                      (blockmax.data_ptr(), q_weights.data_ptr(), theta.data_ptr(),
                       ub.data_ptr(), survive.data_ptr()) + plan.ints, blockmax.get_device())
        LAUNCHES += 1
    return ub, survive


def block_prune_batched(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``(ub f32[B, NB], survive bool[B, NB])`` for ``blockmax
    [B, Lq, NB]``, ``q_weights [B, Lq]`` and per-query thresholds ``theta
    [B]``: ``ub = sum_l qw_l * blockmax[l]``, ``survive = (ub > theta) &
    (ub > 0)``. One launch covers the batch; rows never mix."""
    args = (
        blockmax.to(torch.float32).contiguous(),
        q_weights.to(torch.float32).contiguous(),
        torch.as_tensor(theta, dtype=torch.float32, device=blockmax.device).contiguous(),
    )
    return common.run_kernel("block_prune", (*args[0].shape, PRUNE_TILE), args[0],
                             lambda: block_prune_batched_ref(*args),
                             lambda: block_prune_launch(*args))


def block_prune(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-query ``[Lq, NB]`` form, a batch of one: ``(ub f32[NB],
    survive bool[NB])``."""
    th = torch.as_tensor(theta, dtype=torch.float32, device=blockmax.device).reshape(1)
    ub, survive = block_prune_batched(blockmax[None], q_weights[None], th)
    return ub[0], survive[0]


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    return [launch_plan(dims.get("batch", 1), dims["lq"], dims["nb"], PRUNE_TILE)]


def _contract_call(dims, device):
    """The wrapper at ``dims``: block maxima with a fifth of them 0, one
    zero-weight slot, thetas at a quantile of the bounds. (The reference's
    ``block_nb`` is its tile; the kernel here tiles the block axis itself.)"""
    rng = np.random.default_rng(dims["lq"] * dims["nb"])
    B = dims.get("batch", 1)
    bm = rng.gamma(1.0, 1.0, (B, dims["lq"], dims["nb"])).astype(np.float32)
    bm[rng.random(bm.shape) < 0.2] = 0.0
    qw = rng.gamma(1.0, 1.0, (B, dims["lq"])).astype(np.float32)
    if dims["lq"] > 2:
        qw[:, 2] = 0.0
    theta = np.quantile(np.einsum("bl,bln->bn", qw, bm), 0.7, axis=-1).astype(np.float32)
    if "batch" not in dims:
        bm, qw, theta = bm[0], qw[0], theta[0]
    fn = block_prune_batched if "batch" in dims else block_prune
    return fn, tuple(torch.as_tensor(a, device=device) for a in (bm, qw, theta))


# The reference contract's cases (same names and dims), then the edges
# chip_smoke.py holds the kernel to at every tile: the engine's widths at
# B = 63 and 1, an Lq of several rounds of loads, one block.
CONTRACT = KernelContract(
    name="block_prune",
    description="fused block-upper-bound + threshold prune (DAAT phase 0's dense oracle)",
    make_call=_contract_call,
    plan=_contract_plan,
    expect_async_copy=True,
    shape_grid=(
        ShapeCase("narrow", dict(lq=8, nb=100, block_nb=256)),
        ShapeCase("wide", dict(lq=32, nb=2048, block_nb=256)),
        ShapeCase("tiny_ragged", dict(lq=5, nb=17, block_nb=256)),
        ShapeCase("b1", dict(batch=1, lq=8, nb=100, block_nb=256)),
        ShapeCase("b4_wide", dict(batch=4, lq=32, nb=2048, block_nb=256)),
        ShapeCase("b3_tiny", dict(batch=3, lq=5, nb=17, block_nb=256)),
        ShapeCase("engine_b63", dict(batch=63, lq=35, nb=2159), port=True),
        ShapeCase("engine_b1", dict(batch=1, lq=35, nb=2159), port=True),
        ShapeCase("lq_past_a_round", dict(batch=2, lq=300, nb=97), port=True),
        ShapeCase("one_block", dict(batch=2, lq=3, nb=1), port=True),
    ),
)
