"""Wrappers around the per-tile top-k CUDA kernel (``csrc/block_topk.cu``):
the two-stage exact top-k.

Stage 1, the kernel, keeps each (query, tile)'s k best; stage 2, the merge
of the ``n_tiles * k`` finalists, stays in the port's plain ``topk``, as the
reference keeps it outside Pallas. Both break ties toward the lowest index,
so the ids equal a single ``topk`` over the whole row. The reference's tile
rule, ``-inf`` padding and padding to k are kept.

For CPU tensors, and only for those, stage 1 runs the plain version in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.

``CONTRACT`` declares the shapes the kernel is checked at and its launch
plan (:func:`launch_plan`, which the launcher takes its numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
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


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, n: int, k: int, tile: int) -> common.LaunchPlan:
    """Stage 1's launch: a CTA a (tile, row), ``select_threads(tile)``
    threads, the warps' lists and the tile in shared memory. The launcher
    divides ``n`` by ``tile`` without rounding up: the wrapper pads."""
    threads = select_threads(tile)
    list_len = select_list_len(tile, k, threads)
    lists = 8 * (threads // 32) * list_len
    return common.LaunchPlan(
        "block_topk", "block_topk_launch", "block_topk_kernel",
        (batch, n, tile, k, threads, list_len, lists + 4 * tile),
        grid=(n // tile, batch, 1), threads=threads,
        smem=((f"warp lists u64[{threads // 32}, {list_len}]", lists),
              (f"tile scores f32[{tile}]", 4 * tile)),
        cover=(("x", n, tile), ("y", batch, 1)), exact=(("n / tile", n, tile),))


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
    plan = launch_plan(B, n, k, tile)
    if plan.smem_bytes > common.SMEM_LIMIT:
        raise ValueError(f"tile={tile}, k={k} needs {plan.smem_bytes} B of shared memory; the "
                         f"limit is {common.SMEM_LIMIT}")
    out_s = torch.empty((B, n // tile, k), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((B, n // tile, k), dtype=torch.int32, device=scores.device)
    if B and n:
        common.launch("block_topk", plan.symbol, 3,
                      (scores.data_ptr(), out_s.data_ptr(), out_i.data_ptr()) + plan.ints,
                      scores.get_device())
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
    ts, ti = common.run_kernel("block_topk", (*s.shape, k_tile, tile), s,
                               lambda: block_topk_stage1_ref(s, k_tile, tile),
                               lambda: block_topk_launch(s, k_tile, tile))
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


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    """Stage 1 as the wrapper launches it: the tile at most ``max(128, n)``,
    the row padded to it, k at most n and the tile."""
    n = dims["n"]
    tile = min(dims["tile"], max(128, n))
    k_tile = min(max(min(dims["k"], n), 1), tile)
    return [launch_plan(dims.get("batch", 1), common.round_up(n, tile), k_tile, tile)]


def _contract_call(dims, device):
    """The wrapper at ``dims`` on scores of few distinct values (ties); the
    first ``neg_inf_rows`` rows all -inf."""
    rng = np.random.default_rng(dims["n"] + dims["k"])
    shape = (dims.get("batch", 1), dims["n"])
    s = rng.integers(0, 5, shape).astype(np.float32)
    s[: dims.get("neg_inf_rows", 0)] = -np.inf
    scores = torch.as_tensor(s if "batch" in dims else s[0], device=device)
    fn = block_topk_batched if "batch" in dims else block_topk
    return functools.partial(fn, k=dims["k"], tile=dims["tile"]), (scores,)


# The reference contract's cases (same names and dims), then the edges
# chip_smoke.py holds the kernel to (tied_scores): the engine's [64, 2159]
# bounds fully tied, with every k it uses and k = 1; rows of all -inf;
# widths that are not a multiple of 32; k past n; B = 1.
CONTRACT = KernelContract(
    name="block_topk",
    description="two-stage exact top-k (per-tile select + finalist merge)",
    make_call=_contract_call,
    plan=_contract_plan,
    shape_grid=(
        ShapeCase("ragged", dict(n=1000, k=10, tile=256)),
        ShapeCase("aligned", dict(n=8192, k=100, tile=1024)),
        ShapeCase("k_is_n", dict(n=100, k=100, tile=128)),
        ShapeCase("wide_tile", dict(n=5000, k=7, tile=512)),
        ShapeCase("b1", dict(batch=1, n=1000, k=10, tile=256)),
        ShapeCase("b3_ragged", dict(batch=3, n=517, k=7, tile=128)),
        ShapeCase("b8_k_is_n", dict(batch=8, n=100, k=100, tile=128)),
        ShapeCase("tied_b64_n2159_k1", dict(batch=64, n=2159, k=1, tile=8192), port=True),
        ShapeCase("tied_b64_n2159_k8", dict(batch=64, n=2159, k=8, tile=8192), port=True),
        ShapeCase("tied_b64_n2159_k16", dict(batch=64, n=2159, k=16, tile=8192), port=True),
        ShapeCase("neginf_rows_b4_n2159_k16",
                  dict(batch=4, n=2159, k=16, tile=8192, neg_inf_rows=2), port=True),
        ShapeCase("ragged_b5_n45_k7", dict(batch=5, n=45, k=7, tile=8192), port=True),
        ShapeCase("ragged_b3_n1001_k1000", dict(batch=3, n=1001, k=1000, tile=8192), port=True),
        ShapeCase("k_past_n_b2_n45_k60", dict(batch=2, n=45, k=60, tile=8192), port=True),
        ShapeCase("b1_n2159_k16", dict(n=2159, k=16, tile=8192), port=True),
    ),
)
