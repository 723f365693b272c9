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

``CONTRACT`` declares the shapes the kernel is checked at and its launch
plan (:func:`launch_plan`, which the launcher takes its numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.core.topk import tiled_topk
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter_topk.ref import impact_scatter_topk_block_ref
from repro_torch.metrics import spans

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


def launch_plan(batch: int, n_slots: int, n_docs: int, n_live: int, k: int,
                block_d: int) -> common.LaunchPlan:
    """The kernel's launch: a CTA a (block of ``block_d`` docs, row) with
    ``impact_scatter_topk_layout``'s threads and shared memory."""
    lay = impact_scatter_topk_layout(block_d, k)
    return common.LaunchPlan(
        "impact_scatter_topk", "impact_scatter_topk_launch",
        f"impact_scatter_topk_kernel<{lay['dpt']}, {str(lay['select']).lower()}>",
        (batch, n_slots, n_docs, n_live, block_d, k, lay["dpt"], lay["stage"],
         int(lay["select"]), lay["n_keys"], lay["list_len"], lay["smem"]),
        grid=(n_docs // block_d, batch, 1), threads=lay["threads"],
        smem=((f"keys u64[{lay['n_keys']}]", 8 * lay["n_keys"]),
              (f"block scores f32[{block_d}]", 4 * block_d),
              (f"staged postings (i32, f32)[{lay['stage']}]", 8 * lay["stage"]),
              (f"run starts i32[{block_d}]", 4 * block_d)),
        # s_range i32[3], which ptxas rounds up to 16 B before the dynamic keys
        static_smem=(("s_range i32[3]", 16),),
        cover=(("x", n_docs, block_d), ("y", batch, 1)),
        exact=(("n_docs / block_d", n_docs, block_d),))


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
    B, P = docs.shape
    nb = n_docs // block_d
    out_s = torch.empty((B, nb, k), dtype=torch.float32, device=docs.device)
    out_i = torch.empty((B, nb, k), dtype=torch.int32, device=docs.device)
    if B and nb:
        plan = launch_plan(B, P, n_docs, n_live, k, block_d)
        common.launch("impact_scatter_topk", plan.symbol, 5,
                      (docs.data_ptr(), contribs.data_ptr(),
                       None if live is None else live.data_ptr(), out_s.data_ptr(), out_i.data_ptr())
                      + plan.ints, docs.get_device())
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
    with spans.span("saat.tile_sort"):
        docs, c = common.sorted_posting_tiles(doc_ids, contribs, n_docs_pad, tile_p)
    if live is not None:
        live = common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()
    n_live = min(n_live, n_docs)
    with spans.span("saat.b1"):
        cand_s, cand_i = common.run_kernel(
            "impact_scatter_topk", (*docs.shape, n_docs_pad, n_live, k_blk, block_d), docs,
            lambda: impact_scatter_topk_block_ref(docs, c, n_docs_pad, n_live, k_blk, block_d,
                                                  live),
            lambda: impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, k_blk, block_d, live))
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


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    """The launch the wrapper makes at ``dims``: slots padded to ``tile_p``,
    docs to ``block_d``, a block's k the least of k, n_docs and block_d."""
    block_d = dims["block_d"]
    n_docs_pad = common.round_up(max(dims["n_docs"], block_d), block_d)
    k_blk = min(dims["k"], dims["n_docs"], block_d)
    return [launch_plan(dims.get("batch", 1), common.round_up(dims["n_postings"], dims["tile_p"]),
                        n_docs_pad, dims["n_docs"], k_blk, block_d)]


def _contract_call(dims, device):
    """The wrapper at ``dims`` on random postings; ``live``: a bitmap with a
    fifth of the docs tombstoned."""
    rng = np.random.default_rng(dims["n_postings"] + dims["n_docs"] + dims["k"])
    shape = ((dims["batch"],) if "batch" in dims else ()) + (dims["n_postings"],)
    docs = torch.as_tensor(rng.integers(0, dims["n_docs"], shape), dtype=torch.int32,
                           device=device)
    c = torch.as_tensor(rng.gamma(2.0, 1.0, shape), dtype=torch.float32, device=device)
    live = None
    if dims.get("live"):
        live = torch.as_tensor(rng.random(dims["n_docs"]) < 0.8, dtype=torch.int32, device=device)
    fn = impact_scatter_topk_batched if "batch" in dims else impact_scatter_topk
    return functools.partial(fn, n_docs=dims["n_docs"], k=dims["k"], live=live,
                             block_d=dims["block_d"], tile_p=dims["tile_p"]), (docs, c)


# The edges of both scatter kernels (impact_scatter's): k_blk on both sides
# of SELECT_MAX_K and at block_d, with and without the bitmap.
EDGE_KS = (1, 10, 16, 32, 33, 512)

# The reference contract's cases (same names and dims), then the edges.
CONTRACT = KernelContract(
    name="impact_scatter_topk",
    description="fused scatter -> per-block top-k candidate pool (SAAT fused_topk)",
    make_call=_contract_call,
    plan=_contract_plan,
    shape_grid=(
        ShapeCase("k1", dict(n_postings=128, n_docs=512, k=1, block_d=256, tile_p=128)),
        ShapeCase("k10_ragged", dict(n_postings=1000, n_docs=1000, k=10, block_d=256, tile_p=128)),
        ShapeCase("k300", dict(n_postings=4096, n_docs=512, k=300, block_d=256, tile_p=128)),
        ShapeCase("live_ragged", dict(n_postings=1000, n_docs=1000, k=10, block_d=256, tile_p=128,
                                      live=1)),
        ShapeCase("b1", dict(batch=1, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128)),
        ShapeCase("b3_ragged", dict(batch=3, n_postings=1000, n_docs=700, k=13, block_d=256,
                                    tile_p=128)),
        ShapeCase("b8", dict(batch=8, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128)),
        ShapeCase("b3_live", dict(batch=3, n_postings=1000, n_docs=700, k=13, block_d=256,
                                  tile_p=128, live=1)),
    ) + tuple(
        ShapeCase(f"edge_k{k}{'_live' if live else ''}",
                  dict(scatter_ops.EDGE, k=k, **({"live": 1} if live else {})), port=True)
        for k in EDGE_KS for live in (False, True)
    ),
)
