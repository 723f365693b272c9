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

The segment entry (:func:`impact_scatter_topk_segments`) computes the same
pool from the SAAT plan itself: its kernel reads each admitted posting's
doc id straight from the index's posting store, so no ``[B, rho]`` posting
array is gathered and no row is sorted by doc. ``core/saat.py`` takes it for
``fused_topk``; the ``[B, P]`` entry above stays the counterpart of the
reference's Pallas kernel.

``CONTRACT`` declares the shapes the kernels are checked at and their
launch plans (:func:`launch_plan`, :func:`segments_launch_plan`, which the
launchers take their numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.core.topk import tiled_topk
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter_topk.ref import (
    impact_scatter_topk_block_ref,
    impact_scatter_topk_segments_ref,
)
from repro_torch.metrics import spans

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after): ``LAUNCHES`` of the
# ``[B, P]`` entry, ``PLAN_LAUNCHES`` of the segment entry.
LAUNCHES = 0
PLAN_LAUNCHES = 0

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


# The segment entry's CTA (csrc/impact_scatter_topk.cu): SEGMENT_THREADS
# threads over SEGMENT_CTA_DOCS docs (16 pool blocks of 512), each segment
# of the plan searched once a CTA, and SEGMENT_PER_THREAD postings a thread
# ordered at once (the kernel's PER_THREAD, fixed at build).
SEGMENT_THREADS = 512
SEGMENT_CTA_DOCS = 8192
SEGMENT_PER_THREAD = 16


def segments_layout(n_docs: int, cta_docs: int = SEGMENT_CTA_DOCS,
                    threads: int = SEGMENT_THREADS) -> dict:
    """The segment kernel's CTA over ``n_docs`` (padded) docs: the docs a
    CTA (``cta_docs``, a power of two, fewer for a small index), its
    threads, the postings a piece (``stage``, ``SEGMENT_PER_THREAD`` a
    thread) and its dynamic shared memory: the running sums and the
    counts (4 B a doc each), the window's columns (12 B a thread, and the
    list's end) and the ordered piece (2 B a posting). ``cta_docs`` and
    ``threads`` other than the constants are for a layout sweep."""
    cta_docs = min(cta_docs, common.next_pow2(n_docs))
    threads = min(threads, cta_docs)
    stage = SEGMENT_PER_THREAD * threads
    return dict(cta_docs=cta_docs, threads=threads, stage=stage,
                smem=8 * cta_docs + 12 * threads + 4 + 2 * stage)


def segments_launch_plan(batch: int, n_cols: int, rho: int, n_docs: int, n_live: int, k: int,
                         block_d: int) -> common.LaunchPlan:
    """The segment kernel's launch: a CTA a (range of ``cta_docs`` docs,
    row) with :func:`segments_layout`'s threads and shared memory."""
    lay = segments_layout(n_docs)
    cta_docs, threads = lay["cta_docs"], lay["threads"]
    return common.LaunchPlan(
        "impact_scatter_topk", "impact_scatter_topk_segments_launch",
        "impact_scatter_topk_segments_kernel",
        (batch, n_cols, rho, n_docs, n_live, block_d, k, cta_docs, threads, lay["smem"]),
        grid=(-(-n_docs // cta_docs), batch, 1), threads=threads,
        smem=((f"running sums f32[{cta_docs}]", 4 * cta_docs),
              (f"counts, then runs i32[{cta_docs}]", 4 * cta_docs),
              (f"window columns (i32, i32, f32)[{threads}] + end", 12 * threads + 4),
              (f"ordered piece u16[{lay['stage']}]", 2 * lay["stage"])),
        # s_scan i32[32] and s_cols i32, which ptxas lays out in 144 B
        static_smem=(("s_scan i32[32], s_cols i32", 144),),
        cover=(("x", n_docs, cta_docs), ("y", batch, 1)),
        exact=(("n_docs / block_d", n_docs, block_d), ("cta_docs / threads", cta_docs, threads)))


def impact_scatter_topk_segments_launch(
    doc_ids: torch.Tensor,
    starts: torch.Tensor,
    contribs: torch.Tensor,
    cum_len: torch.Tensor,
    rho: int,
    n_docs: int,
    n_live: int,
    k: int,
    block_d: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the segment kernel: ``(f32, i32)[B, n_docs // block_d, k]``.

    ``doc_ids`` i32[P] (each segment ascending, a doc at most once in it,
    values in ``[0, n_docs)``); the plan's ``starts`` i32, ``contribs`` f32
    and inclusive ``cum_len`` i32, all ``[B, C]``; ``live`` optional
    i32[n_docs]; ``0 <= rho < 2**31``, ``n_docs % block_d == 0`` and
    ``0 < k <= block_d``.
    """
    global PLAN_LAUNCHES
    common.check_block_d(block_d)
    args = (doc_ids, starts, contribs, cum_len) + (() if live is None else (live,))
    common.check_cuda_tensors(*args)
    common.check_dtypes(doc_ids=(doc_ids, torch.int32), starts=(starts, torch.int32),
                        contribs=(contribs, torch.float32), cum_len=(cum_len, torch.int32))
    if (starts.ndim != 2 or starts.shape != contribs.shape or starts.shape != cum_len.shape
            or not starts.shape[1]):
        raise ValueError(f"expected matching [B, C] plan fields with C > 0, got {starts.shape}, "
                         f"{contribs.shape}, {cum_len.shape}")
    if not 0 <= rho < 2**31:
        raise ValueError(f"rho must lie in [0, 2**31), got {rho}")
    if n_docs % block_d:
        raise ValueError(f"n_docs {n_docs} is not a multiple of block_d {block_d}")
    if not 0 < k <= block_d:
        raise ValueError(f"k must lie in (0, block_d={block_d}], got {k}")
    if live is not None and (live.dtype != torch.int32 or live.shape != (n_docs,)):
        raise ValueError(f"live must be i32[{n_docs}], got {live.dtype}{list(live.shape)}")
    B, C = starts.shape
    nb = n_docs // block_d
    out_s = torch.empty((B, nb, k), dtype=torch.float32, device=starts.device)
    out_i = torch.empty((B, nb, k), dtype=torch.int32, device=starts.device)
    if B and nb:
        plan = segments_launch_plan(B, C, rho, n_docs, n_live, k, block_d)
        common.launch("impact_scatter_topk", plan.symbol, 7,
                      (doc_ids.data_ptr(), starts.data_ptr(), contribs.data_ptr(),
                       cum_len.data_ptr(), None if live is None else live.data_ptr(),
                       out_s.data_ptr(), out_i.data_ptr()) + plan.ints, starts.get_device())
        PLAN_LAUNCHES += 1
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


def _pool_shape(n_docs: int, k: int, n_live: int | None, live: torch.Tensor | None,
                block_d: int) -> tuple:
    """What both entries' pools share: ``(n_docs_pad, k_out, k_blk, n_live,
    live)``, the docs padded to ``block_d``, the top-k's width and a
    block's, the live doc count and the bitmap padded to ``n_docs_pad``."""
    common.check_block_d(block_d)  # the same limits on the CPU as on the card
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    k_out = min(k, n_docs)
    k_blk = min(k_out, block_d)  # a block holds at most block_d of the top-k
    if live is not None:
        live = common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()
    return n_docs_pad, k_out, k_blk, min(n_docs if n_live is None else n_live, n_docs), live


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
    n_docs_pad, k_out, k_blk, n_live, live = _pool_shape(n_docs, k, n_live, live, block_d)
    with spans.span("saat.tile_sort"):
        docs, c = common.sorted_posting_tiles(doc_ids, contribs, n_docs_pad, tile_p)
    with spans.span("saat.b1"):
        cand_s, cand_i = common.run_kernel(
            "impact_scatter_topk", (*docs.shape, n_docs_pad, n_live, k_blk, block_d), docs,
            lambda: impact_scatter_topk_block_ref(docs, c, n_docs_pad, n_live, k_blk, block_d,
                                                  live),
            lambda: impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, k_blk, block_d, live))
        return _merge_pool(cand_s, cand_i, k_out)


def impact_scatter_topk_segments(
    doc_ids: torch.Tensor,
    starts: torch.Tensor,
    contribs: torch.Tensor,
    cum_len: torch.Tensor,
    rho: int,
    n_docs: int,
    k: int,
    *,
    n_live: int | None = None,
    live: torch.Tensor | None = None,
    block_d: int = 512,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the masked scatter accumulator of each row's first
    ``min(rho, cum_len[b, -1])`` plan postings, read from the posting store
    ``doc_ids``: ``[B, min(k, n_docs)]``, the same scores and ids as
    :func:`impact_scatter_topk_batched` on the gathered postings.

    ``starts``, ``contribs`` and ``cum_len`` are a ``SaatPlan``'s fields,
    ``[B, C]``. Ids ``>= n_live`` (default ``n_docs``) and ids whose
    ``live`` entry is 0 score ``-inf``. Neither the postings nor the
    accumulator reach device memory, and the host reads nothing.
    """
    n_docs_pad, k_out, k_blk, n_live, live = _pool_shape(n_docs, k, n_live, live, block_d)
    rho = min(int(rho), 2**31 - 1)  # a row admits at most its own total
    with spans.span("saat.b1"):
        cand_s, cand_i = common.run_kernel(
            "impact_scatter_topk_segments",
            (*starts.shape, rho, n_docs_pad, n_live, k_blk, block_d), starts,
            lambda: impact_scatter_topk_segments_ref(doc_ids, starts, contribs, cum_len, rho,
                                                     n_docs_pad, n_live, k_blk, block_d, live),
            lambda: impact_scatter_topk_segments_launch(doc_ids, starts, contribs, cum_len, rho,
                                                        n_docs_pad, n_live, k_blk, block_d,
                                                        live))
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
    docs to ``block_d``, a block's k the least of k, n_docs and block_d; a
    segment case launches the segment kernel on its plan's width."""
    block_d = dims["block_d"]
    n_docs_pad = common.round_up(max(dims["n_docs"], block_d), block_d)
    k_blk = min(dims["k"], dims["n_docs"], block_d)
    if dims.get("segments"):
        return [segments_launch_plan(dims["batch"], dims["n_cols"], _segment_rho(dims),
                                     n_docs_pad, dims["n_docs"], k_blk, block_d)]
    return [launch_plan(dims.get("batch", 1), common.round_up(dims["n_postings"], dims["tile_p"]),
                        n_docs_pad, dims["n_docs"], k_blk, block_d)]


def segment_plan_inputs(dims, device):
    """A posting store and a SAAT-plan-shaped schedule over it at ``dims``:
    ``n_segs`` segments of 1 to ``seg_len`` distinct docs below ``n_docs``,
    each ascending, as the index stores them; each of ``batch`` rows takes
    ``n_cols`` columns, a random count of them real (segments drawn with
    repeats, as a query's repeated term gives) and the rest the plan's
    zero-length pad columns, with gamma-distributed contributions.
    -> ``(doc_ids, starts, contribs, cum_len)``."""
    rng = np.random.default_rng([dims["n_docs"], dims["n_segs"], dims["n_cols"], dims["batch"]])
    lens = rng.integers(1, min(dims["seg_len"], dims["n_docs"]) + 1, dims["n_segs"])
    store = np.concatenate([np.sort(rng.choice(dims["n_docs"], n, replace=False)) for n in lens])
    seg_start = np.cumsum(lens) - lens
    shape = (dims["batch"], dims["n_cols"])
    seg = rng.integers(0, dims["n_segs"], shape)
    real = np.arange(dims["n_cols"]) < rng.integers(0, dims["n_cols"] + 1, (dims["batch"], 1))
    real[0] = True  # the first row takes every column: rho_mid cuts it
    starts = np.where(real, seg_start[seg], 0)
    contribs = np.where(real, rng.gamma(2.0, 1.0, shape), 0.0)
    cum = np.cumsum(np.where(real, lens[seg], 0), axis=1)
    return tuple(torch.as_tensor(a, dtype=dt, device=device) for a, dt in (
        (store, torch.int32), (starts, torch.int32), (contribs, torch.float32), (cum, torch.int32)))


def _segment_rho(dims) -> int:
    """The case's rho, or with ``rho_mid`` half-way into the first row's
    middle column (a cut inside a segment)."""
    if not dims.get("rho_mid"):
        return dims["rho"]
    cum = segment_plan_inputs(dims, "cpu")[3][0]
    j = dims["n_cols"] // 2
    return int(cum[j - 1] + cum[j]) // 2


def _contract_call(dims, device):
    """The wrapper at ``dims`` on random postings (a segment case: on
    :func:`segment_plan_inputs`); ``live``: a bitmap with a fifth of the
    docs tombstoned."""
    if dims.get("segments"):
        rng = np.random.default_rng(dims["n_docs"] + dims["k"])
        live = None
        if dims.get("live"):
            live = torch.as_tensor(rng.random(dims["n_docs"]) < 0.8, dtype=torch.int32,
                                   device=device)
        return functools.partial(impact_scatter_topk_segments, rho=_segment_rho(dims),
                                 n_docs=dims["n_docs"], k=dims["k"], live=live,
                                 block_d=dims["block_d"]), segment_plan_inputs(dims, device)
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

# The segment entry's cases: a CTA of one range (ragged n_docs 1,000) and of
# three (20,000 docs in ranges of 8,192, the last one short), block_d at 64
# and 1,024, k_blk on both sides of SELECT_MAX_K and at block_d, with and
# without the bitmap; rho cutting a segment, at and past every total; more
# columns than a CTA's threads (two windows) and more postings than a piece.
SEGMENT = dict(segments=1, batch=3, n_docs=1000, n_segs=40, seg_len=300, n_cols=24, k=10,
               block_d=256, rho=2000)
SEGMENT_BIG = dict(SEGMENT, n_docs=20000, n_segs=60, seg_len=6000, n_cols=40, block_d=512,
                   rho=60000)
SEGMENT_CASES = (
    ("seg_k1_block64", dict(SEGMENT, k=1, block_d=64)),
    ("seg_k32", dict(SEGMENT, k=32)),
    ("seg_k33_live", dict(SEGMENT, k=33, live=1)),
    ("seg_k1024_block1024", dict(SEGMENT, k=1024, block_d=1024)),
    ("seg_rho_mid", dict(SEGMENT, rho_mid=1)),
    ("seg_rho_mid_live", dict(SEGMENT, rho_mid=1, live=1)),
    ("seg_exact", dict(SEGMENT, rho=2**31 - 1)),
    ("seg_b1", dict(SEGMENT, batch=1)),
    ("seg_windows", dict(SEGMENT, n_cols=700, n_segs=300, rho=2**31 - 1)),
    ("seg_ranges_k10", dict(SEGMENT_BIG)),
    ("seg_ranges_k33_live", dict(SEGMENT_BIG, k=33, live=1)),
    ("seg_ranges_k512", dict(SEGMENT_BIG, k=512, rho_mid=1)),
)

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
    ) + tuple(ShapeCase(name, dims, port=True) for name, dims in SEGMENT_CASES),
)
