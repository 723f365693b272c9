"""Wrappers around the per-tile top-k CUDA kernel (``csrc/block_topk.cu``):
the two-stage exact top-k.

Stage 1, the kernel, keeps each (query, tile)'s k best; stage 2, the merge
of the ``n_tiles * k`` finalists, stays in the port's plain ``topk``, as the
reference keeps it outside Pallas. Both break ties toward the lowest index,
so the ids equal a single ``topk`` over the whole row. The reference's tile
rule, ``-inf`` padding and padding to k are kept.

For CPU tensors, and only for those, stage 1 runs the plain version in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.
"""
from __future__ import annotations


import torch

from repro_torch.core.topk import topk
from repro_torch.kernels import common
from repro_torch.kernels.block_topk.ref import block_topk_stage1_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0


def select_threads(tile: int) -> int:
    """Threads of a ``block_topk`` CTA: one warp per 32 scores of the tile,
    at most 1,024."""
    return min(1024, common.round_up(tile, 32))


def select_list_len(m: int, n: int, threads: int) -> int:
    """Length of each warp's list in ``block_select_desc``
    (``select_common.cuh``): ``min(n, the most keys one warp owns)``."""
    return min(n, 32 * -(-m // threads))


def block_topk_smem(tile: int, k: int) -> int:
    """Shared memory of a ``block_topk`` CTA: the warps' lists and the tile."""
    threads = select_threads(tile)
    return 8 * (threads // 32) * select_list_len(tile, k, threads) + 4 * tile


def block_topk_launch(
    scores: torch.Tensor, k: int, tile: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch stage 1: ``scores f32[B, n]``, ``n % tile == 0``, ``0 < k <= tile``
    -> ``(f32, i32)[B, n // tile, k]``."""
    global LAUNCHES
    common.check_cuda_tensors(scores)
    common.check_dtypes(scores=(scores, torch.float32))
    B, n = scores.shape
    if n % tile or not 0 < k <= tile:
        raise ValueError(f"need n % tile == 0 and 0 < k <= tile, got n={n}, tile={tile}, k={k}")
    smem = block_topk_smem(tile, k)
    if smem > common.SMEM_LIMIT:
        raise ValueError(f"tile={tile}, k={k} needs {smem} B of shared memory; the limit is "
                         f"{common.SMEM_LIMIT}")
    threads = select_threads(tile)
    out_s = torch.empty((B, n // tile, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((B, n // tile, k), dtype=torch.int32, device=scores.device)
    if B and n:
        common.launch("block_topk", "block_topk_launch", 3,
                      (scores.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), B, n, tile, k,
                       threads, select_list_len(tile, k, threads), smem), scores.get_device())
        LAUNCHES += 1
    return out_s, out_i


def block_topk_batched(
    scores: torch.Tensor, k: int, *, tile: int = 8192
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-k over ``scores [B, n]``: ``(f32, i32)[B, k]``.

    Ranks past ``n`` (``k > n``) hold ``-inf`` and id 0.
    """
    b, n = scores.shape
    tile = min(tile, max(128, n))
    k_eff = min(k, n)
    s = common.pad_axis(scores.to(torch.float32), 1, tile, fill=float("-inf")).contiguous()
    k_tile = min(max(k_eff, 1), tile)
    if s.device.type == "cpu":
        ts, ti = block_topk_stage1_ref(s, k_tile, tile)
    else:
        ts, ti = block_topk_launch(s, k_tile, tile)
    fs, fi = topk(ts.reshape(b, -1), k_eff)
    ids = torch.gather(ti.reshape(b, -1), -1, fi)
    if k_eff < k:  # pad to the requested k for shape stability
        fs = torch.cat([fs, fs.new_full((b, k - k_eff), float("-inf"))], dim=-1)
        ids = torch.cat([ids, ids.new_zeros((b, k - k_eff))], dim=-1)
    return fs, ids


def block_topk(scores: torch.Tensor, k: int, *, tile: int = 8192) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a 1-D score vector: a batch of one. ``([k], [k])``."""
    s, i = block_topk_batched(scores[None], k, tile=tile)
    return s[0], i[0]
