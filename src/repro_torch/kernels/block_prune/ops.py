"""Wrappers around the dense block-prune CUDA kernel (``csrc/block_prune.cu``).

The engine's phase 0 runs off the CSR lists (``block_prune_csr``); this
kernel takes the dense ``[B, Lq, NB]`` block maxima that
:func:`repro_torch.core.daat._dense_blockmax_rows` builds, and serves as
the CSR kernel's oracle, as in the reference. The kernel masks its own
ragged tile, so unlike the reference's wrapper these pad no block axis.

For CPU tensors, and only for those, they run the plain version in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.block_prune.ref import block_prune_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

# The kernel keeps one query's weights in (static-limit) shared memory.
MAX_LQ = 48 * 1024 // 4


def block_prune_launch(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``blockmax f32[B, Lq, NB]``, ``q_weights f32[B, Lq]``,
    ``theta f32[B]`` -> ``(ub f32, survive bool)[B, NB]``."""
    global LAUNCHES
    common.check_cuda_tensors(blockmax, q_weights, theta)
    common.check_dtypes(blockmax=(blockmax, torch.float32), q_weights=(q_weights, torch.float32),
                        theta=(theta, torch.float32))
    B, lq, nb = blockmax.shape
    if q_weights.shape != (B, lq) or theta.shape != (B,):
        raise ValueError("q_weights must be [B, Lq] and theta [B] for blockmax [B, Lq, NB]")
    if lq > MAX_LQ or B > 65535:
        raise ValueError(f"the kernel takes Lq <= {MAX_LQ} and B <= 65535, got {lq}, {B}")
    lib = common.kernel_library("block_prune")
    fn = lib.block_prune_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ub = torch.empty((B, nb), dtype=torch.float32, device=blockmax.device)
    survive = torch.empty((B, nb), dtype=torch.bool, device=blockmax.device)
    if B and nb:
        code = fn(common.ptr(blockmax), common.ptr(q_weights), common.ptr(theta), common.ptr(ub),
                  common.ptr(survive), B, lq, nb, common.stream_of(blockmax))
        common.raise_on_error("block_prune", code)
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
    if blockmax.device.type == "cpu":
        return block_prune_batched_ref(*args)
    return block_prune_launch(*args)


def block_prune(
    blockmax: torch.Tensor, q_weights: torch.Tensor, theta
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-query ``[Lq, NB]`` form, a batch of one: ``(ub f32[NB],
    survive bool[NB])``."""
    th = torch.as_tensor(theta, dtype=torch.float32, device=blockmax.device).reshape(1)
    ub, survive = block_prune_batched(blockmax[None], q_weights[None], th)
    return ub[0], survive[0]
