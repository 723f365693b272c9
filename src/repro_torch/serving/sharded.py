"""Doc-sharded retrieval: the paper's serve step over a mesh of ranks.

The port of ``repro.serving.sharded``. Documents are split into
``n_shards`` equal ranges; every rank owns the impact indexes of its shards
and runs the identical rho-budgeted SAAT scan (or block-max DAAT) over
them. Only each rank's k finalists are gathered (``k * 8`` bytes a query
and rank, against ``n_docs * 4`` for the accumulators). Queries batch over
the data axes.

Why this is the scale-out for the paper's technique:
  * a rank's SAAT work is ``rho_per_shard`` postings a shard, identical by
    construction, so corpus skew cannot make a straggler (the paper's
    predictable latency, promoted to a cluster property);
  * DAAT loops until each rank's own batch is rank-safe, so skew does.

The reference runs one SPMD program under ``shard_map``. The port runs the
same program on one of two paths behind one ``serve``:

  * **in process** (``group=None``, the default): this process plays every
    rank in turn, in the mesh's flat rank order
    (``repro_torch.distributed.sharding``), and the tiled all-gather is the
    concatenation of the ranks' pools in that order. Operands and answer
    are global, as the reference's caller sees them.
  * **collective** (``group=`` a ``torch.distributed`` process group whose
    ranks are the mesh's): this process runs its own rank only, and every
    operand is this rank's block of it (the rows its ``in_specs`` give it,
    see :func:`rank_block`): only those rows need to be on its device. The
    gathers are ``all_gather_into_tensor``; ``serve`` returns the rank's
    block of the answer, as the reference's per-rank body does.

Both paths compute a rank's pool as the reference does: each local shard
searched, pad documents demoted to ``(-inf, INT32_MAX)`` before ids are
made global, the local shards folded with ``merge_topk``, then the
id-canonical merge across ranks.

The specs name, for each leading dimension of an operand, the mesh axes it
is split over (a tuple of names, major to minor) or ``None``; the port has
no ``PartitionSpec``. One difference from the reference: the tombstone
stack of a ``live_masked`` step is split over the same axes as the index
stack, so a rank's shard ``j`` always meets its own row. The reference
replicates it (``P()``) and indexes it by the local ``j``, which matches
only when one rank holds every shard, as at the (1, 1) layout its tests run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.daat import daat_search_batched
from repro_torch.core.impact_index import (
    ARRAY_FIELDS,
    META_FIELDS as _META_FIELDS,
    ImpactIndex,
    build_impact_index,
)
from repro_torch.core.saat import saat_search
from repro_torch.core.topk import canonical_topk_merge, gather_ranks, merge_topk
from repro_torch.distributed.sharding import Mesh, block, mesh_axes
from repro_torch.serving.bucketing import bucketize_batch, normalize_buckets

NEG_INF = float("-inf")
INT32_MAX = int(np.iinfo(np.int32).max)


# --------------------------------------------------------------------------
# shard construction (host side)
# --------------------------------------------------------------------------


def shard_corpus(
    doc_idx: np.ndarray,
    term_idx: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    n_terms: int,
    n_shards: int,
    **build_kwargs,
) -> tuple[list[ImpactIndex], int]:
    """Split a COO corpus into per-shard impact indexes (equal doc ranges).

    All shards quantize against the GLOBAL max weight, so their impact
    grids (and merged scores) equal a global index's. Pass an explicit
    ``quant_max_weight`` to pin another grid: re-sharding a compacted
    :class:`~repro_torch.core.index_handle.IndexHandle` reuses the handle's
    pinned grid. ``build_kwargs`` go to ``build_impact_index`` (``device``
    among them: ``cuda`` unless the caller passes ``"cpu"``).
    """
    docs_per_shard = -(-n_docs // n_shards)
    global_max = build_kwargs.pop(
        "quant_max_weight", float(np.max(weights)) if len(weights) else 1.0
    )
    shards = []
    for s in range(n_shards):
        lo, hi = s * docs_per_shard, min((s + 1) * docs_per_shard, n_docs)
        m = (doc_idx >= lo) & (doc_idx < hi)
        shards.append(
            build_impact_index(
                doc_idx[m] - lo, term_idx[m], weights[m], docs_per_shard, n_terms,
                quant_max_weight=global_max, **build_kwargs
            )
        )
    return shards, docs_per_shard


def _pad_cat(arrs: Sequence[torch.Tensor], fill) -> torch.Tensor:
    n = max(a.shape[0] for a in arrs)
    out = arrs[0].new_full((len(arrs), n) + tuple(arrs[0].shape[1:]), fill)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def shard_live_stack(
    live_full: np.ndarray,
    *,
    n_shards: int,
    docs_per_shard: int,
    n_docs_pad: int,
) -> np.ndarray:
    """Slice a global live bitmap into the per-shard tombstone stack.

    ``live_full`` is the corpus-wide i32/bool bitmap over global doc ids
    (e.g. ``IndexHandle.live_mask_full()``); the result is
    ``i32[n_shards, n_docs_pad]``: shard ``s`` holds gids
    ``[s * docs_per_shard, (s+1) * docs_per_shard)``, and the trailing pad
    slots (block padding, and the short final shard's tail) are dead, so a
    pad doc can never out-compete a real one inside the engines' masked
    scans. ``n_docs_pad`` is the per-shard doc pad, the engines'
    accumulator length: ``index_stack.doc_n_terms.shape[1]`` of the stacked
    index (not the posting-store width). Hand it to a ``live_masked=True``
    serve step.
    """
    if n_docs_pad < docs_per_shard:
        raise ValueError(
            f"n_docs_pad={n_docs_pad} smaller than docs_per_shard={docs_per_shard}"
        )
    live_full = np.asarray(live_full).astype(np.int32).ravel()
    out = np.zeros((n_shards, n_docs_pad), np.int32)
    for s in range(n_shards):
        lo = s * docs_per_shard
        hi = min(lo + docs_per_shard, live_full.shape[0])
        if hi > lo:
            out[s, : hi - lo] = live_full[lo:hi]
    return out


def stack_indexes(shards: list[ImpactIndex]) -> ImpactIndex:
    """Stack per-shard indexes on a new leading axis (ragged -> padded), on
    the shards' device.

    Static metadata comes from shard 0 (shards are built with identical
    corpus-level constants) but for the size-like bounds, which take the
    max; per-term CSR tables are padded per shard, and the doc-major stores
    re-padded to a common Tmax (terms with ``n_terms``, weights with 0).
    """
    stacked = {}
    for f in ARRAY_FIELDS:
        if f in ("doc_terms", "doc_weights"):
            continue  # ragged in BOTH dims; re-padded below
        stacked[f] = _pad_cat([getattr(s, f) for s in shards], 0)
    _RAGGED_META = ("max_doc_terms", "max_segs", "max_bm")
    meta = {k: getattr(shards[0], k) for k in _META_FIELDS if k not in _RAGGED_META}
    for k in _RAGGED_META:
        meta[k] = max(getattr(s, k) for s in shards)
    tmax = meta["max_doc_terms"]
    nd = max(s.doc_terms.shape[0] for s in shards)
    dt = shards[0].doc_terms.new_full((len(shards), nd, tmax), shards[0].n_terms)
    dw = shards[0].doc_weights.new_zeros((len(shards), nd, tmax))
    for i, s in enumerate(shards):
        a, b = s.doc_terms, s.doc_weights
        dt[i, : a.shape[0], : a.shape[1]] = a
        dw[i, : b.shape[0], : b.shape[1]] = b
    stacked["doc_terms"] = dt
    stacked["doc_weights"] = dw
    return ImpactIndex(**stacked, **meta)


def abstract_stacked_index(
    *,
    n_shards: int,
    docs_per_shard: int,
    n_terms: int,
    postings_per_shard: int,
    segments_per_shard: int,
    bm_cells_per_shard: int,
    max_doc_terms: int,
    block_size: int = 128,
) -> ImpactIndex:
    """The stacked index's shapes and dtypes, as tensors on the ``meta``
    device (no allocation)."""
    S = n_shards
    f32 = torch.float32
    i32 = torch.int32

    def sds(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    n_docs_pad = -(-docs_per_shard // block_size) * block_size
    n_blocks = n_docs_pad // block_size
    return ImpactIndex(
        doc_ids=sds((S, postings_per_shard), i32),
        seg_term=sds((S, segments_per_shard), i32),
        seg_weight=sds((S, segments_per_shard), f32),
        seg_start=sds((S, segments_per_shard), i32),
        seg_len=sds((S, segments_per_shard), i32),
        term_seg_start=sds((S, n_terms + 1), i32),
        term_seg_count=sds((S, n_terms + 1), i32),
        term_post_count=sds((S, n_terms + 1), i32),
        term_max_weight=sds((S, n_terms + 1), f32),
        bm_block=sds((S, bm_cells_per_shard), i32),
        bm_weight=sds((S, bm_cells_per_shard), f32),
        term_bm_start=sds((S, n_terms + 1), i32),
        term_bm_count=sds((S, n_terms + 1), i32),
        doc_terms=sds((S, n_docs_pad, max_doc_terms), i32),
        doc_weights=sds((S, n_docs_pad, max_doc_terms), f32),
        doc_n_terms=sds((S, n_docs_pad), i32),
        doc_weight_sum=sds((S, n_docs_pad), f32),
        n_docs=docs_per_shard,
        n_terms=n_terms,
        n_blocks=n_blocks,
        block_size=block_size,
        max_doc_terms=max_doc_terms,
        scale=1.0,
        bits=8,
    )


# --------------------------------------------------------------------------
# ranks and their blocks
# --------------------------------------------------------------------------


def _rows(x, pos: int, count: int):
    """Block ``pos`` of ``count`` equal blocks of ``x``'s leading axis."""
    n = x.shape[0]
    if n % count:
        raise ValueError(f"leading dim {n} does not split into {count} equal blocks")
    step = n // count
    return x[pos * step : (pos + 1) * step]


def rank_block(x, spec, mesh: Mesh, rank: int):
    """The block of operand ``x`` that rank ``rank`` holds under ``spec``
    (one entry of a step's ``in_specs``): what the reference's ``shard_map``
    hands that rank's body, and what a collective-path ``serve`` takes.

    ``x`` is a stacked :class:`ImpactIndex` (``spec``: the per-field dict)
    or an array or tensor (``spec``: a tuple of the axes each leading dim is
    split over, or ``None``; ``repro_torch.distributed.sharding.block``).
    """
    if isinstance(x, ImpactIndex):
        return dataclasses.replace(
            x, **{f: rank_block(getattr(x, f), spec[f], mesh, rank) for f in ARRAY_FIELDS}
        )
    return block(x, spec, mesh, rank)


# --------------------------------------------------------------------------
# the sharded serve step
# --------------------------------------------------------------------------


def _validate_engine_cfg(
    engine: str,
    max_bm_per_term: int,
    daat_use_kernels: bool,
    daat_fused_chunk: bool,
    daat_trips_per_launch: int,
):
    if engine not in ("saat", "daat"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "daat" and max_bm_per_term <= 0:
        raise ValueError("engine='daat' needs the static max_bm_per_term bound")
    if daat_fused_chunk and not daat_use_kernels:
        raise ValueError(
            "daat_fused_chunk fuses the kernel-mode chunk step; pass "
            "daat_use_kernels=True"
        )
    if daat_trips_per_launch < 1:
        raise ValueError(
            f"daat_trips_per_launch={daat_trips_per_launch} must be >= 1"
        )
    if daat_trips_per_launch > 1 and not daat_fused_chunk:
        raise ValueError(
            "daat_trips_per_launch > 1 batches trips inside the fused "
            "chunk_step kernel; pass daat_fused_chunk=True (and "
            "daat_use_kernels=True)"
        )


def _local_index(idx_data: dict, j: int, docs_per_shard: int, meta: dict) -> ImpactIndex:
    """Local shard ``j`` of a rank's block as an :class:`ImpactIndex` (views
    of the stack's rows)."""
    local = {f: x[j] for f, x in idx_data.items()}
    return ImpactIndex(**local, **_static_meta_from(local, docs_per_shard, meta))


def _scan_local_shards(
    idx_data: dict, qt, qw, *, shard_ord0: int, st: dict, meta_cell: dict, live=None
):
    """Search every doc shard this rank holds; merge their k-pools.

    ``shard_ord0`` is the rank's position along the axes the shard axis is
    split over, so local shard ``j`` is global shard ``shard_ord0 * n_local
    + j``. Pad documents (block-padding slots and, on a short final shard,
    ids past the corpus end) are demoted to ``(-inf, INT32_MAX)`` *before*
    ids are made global, so they never alias a real doc id in a later
    shard's range. ``live`` is the rank's block of the tombstone stack,
    ``i32[n_local, n_docs_pad]``: shard ``j``'s row rides the engines'
    ``live_mask``, so deleted docs score ``-inf`` inside the scan. Returns
    the rank's merged ``(scores, gids)`` pool, ``[B, k]``.
    """
    n_local = next(iter(idx_data.values())).shape[0]
    docs_per_shard = st["docs_per_shard"]
    pool_s = pool_i = None
    for j in range(n_local):
        index = _local_index(idx_data, j, docs_per_shard, meta_cell)
        lv = live[j] if live is not None else None
        if st["engine"] == "daat":
            res = daat_search_batched(
                index,
                qt,
                qw,
                k=st["k"],
                est_blocks=st["daat_est_blocks"],
                block_budget=st["daat_block_budget"],
                max_bm_per_term=st["max_bm_per_term"],
                exact=st["daat_exact"],
                use_kernels=st["daat_use_kernels"],
                fused_chunk=st["daat_fused_chunk"],
                trips_per_launch=st["daat_trips_per_launch"],
                live_mask=lv,
            )
        else:
            res = saat_search(
                index,
                qt,
                qw,
                k=st["k"],
                rho=st["rho_per_shard"],
                max_segs_per_term=st["max_segs_per_term"],
                scatter_impl=st["scatter_impl"],
                fused_topk=st["fused_topk"],
                live_mask=lv,
            )
        shard_ord = shard_ord0 * n_local + j
        if st["n_docs_total"] is None:
            n_live = docs_per_shard
        else:
            n_live = min(max(st["n_docs_total"] - shard_ord * docs_per_shard, 0), docs_per_shard)
        pad = res.doc_ids >= n_live
        scores = torch.where(pad, NEG_INF, res.scores)
        gids = torch.where(
            pad, INT32_MAX, res.doc_ids + shard_ord * docs_per_shard
        ).to(torch.int32)
        if pool_s is None:
            pool_s, pool_i = scores, gids
        else:
            pool_s, pool_i = merge_topk(pool_s, pool_i, scores, gids, st["k"])
    return pool_s, pool_i


class _Operands:
    """A step's operands checked and placed: the index stack's tensors on
    the mesh's device, the queries as i32/f32 tensors there, and the
    tombstone stack (or ``None``) as i32."""

    def __init__(self, mesh: Mesh, what: str, live_masked: bool,
                 index_stack: ImpactIndex, q_terms, q_weights, live_stack):
        if live_masked and live_stack is None:
            raise ValueError(
                f"this {what} was built live_masked=True; pass the "
                "per-shard live_stack (see shard_live_stack)"
            )
        if not live_masked and live_stack is not None:
            raise ValueError(
                f"live_stack passed to a {what} built without "
                "live_masked=True; rebuild the step with live_masked=True"
            )
        dev = mesh.device
        if index_stack.device != dev:
            raise ValueError(
                f"the index stack is on {index_stack.device}, the mesh on {dev}; "
                "place it with index_stack.to(mesh.device)"
            )
        self.meta = dict(
            block_size=index_stack.block_size,
            scale=index_stack.scale,
            bits=index_stack.bits,
            max_segs=index_stack.max_segs,
            max_bm=index_stack.max_bm,
        )
        self.data = _index_data_dict(index_stack)
        self.qt = torch.as_tensor(q_terms, dtype=torch.int32, device=dev)
        self.qw = torch.as_tensor(q_weights, dtype=torch.float32, device=dev)
        self.live = (
            None if live_stack is None
            else torch.as_tensor(live_stack, dtype=torch.int32, device=dev)
        )

    def rank_rows(self, pos: int, count: int):
        """The index rows and tombstone rows of block ``pos`` of ``count``."""
        data = {f: _rows(x, pos, count) for f, x in self.data.items()}
        return data, None if self.live is None else _rows(self.live, pos, count)


def _check_group(mesh: Mesh, group) -> int:
    world = dist.get_world_size(group)
    if world != mesh.size:
        raise ValueError(f"the process group has {world} ranks, the mesh {mesh.size}")
    return dist.get_rank(group)


def make_sharded_serve_step(
    mesh: Mesh,
    *,
    k: int,
    rho_per_shard: int,
    max_segs_per_term: int,
    docs_per_shard: int,
    scatter_impl: str = "sort",
    fused_topk: bool = False,
    engine: str = "saat",
    daat_est_blocks: int = 8,
    daat_block_budget: int = 16,
    max_bm_per_term: int = 0,
    daat_exact: bool = True,
    daat_use_kernels: bool = False,
    daat_fused_chunk: bool = False,
    daat_trips_per_launch: int = 1,
    n_docs_total: Optional[int] = None,
    live_masked: bool = False,
    group: Optional[dist.ProcessGroup] = None,
):
    """Builds ``serve(index_stack, q_terms, q_weights) -> (scores, ids)``.

    The shard axis of the stack is split over ``"model"``, the query batch
    over the data axes. Every model rank runs the identical rho-budgeted
    SAAT over its shards, makes its ids global by its shard offsets, and
    the ranks of a data group merge their finalists with the id-canonical
    k-merge. ``engine="daat"`` runs the natively batched block-max engine
    a shard instead (``rho_per_shard`` is then unused; pass the static
    ``max_bm_per_term`` from the stacked index's build-time metadata): a
    rank then loops until its own batch is rank-safe, so corpus skew can
    make stragglers, the contrast with SAAT the paper draws.

    ``fused_topk`` takes each shard's SAAT scan through
    ``impact_scatter_topk``, ``scatter_impl="kernel"`` through
    ``impact_scatter``; ``daat_use_kernels``, ``daat_fused_chunk`` and
    ``daat_trips_per_launch`` choose the DAAT kernel modes as in
    ``daat_search_batched``.

    ``n_docs_total`` (the unsharded corpus size) bounds every shard's live
    doc range: block-padding slots and ids past the corpus end on a short
    final shard come out as ``(-inf, INT32_MAX)``. Omitting it still masks
    each shard's block padding but assumes every shard is full.

    ``live_masked=True`` builds the lifecycle variant: ``serve`` then takes
    a ``live_stack``, the per-shard tombstone bitmap ``i32[n_shards,
    n_docs_pad]`` (:func:`shard_live_stack`) in the index stack's shard
    order, and each shard's row rides the engines' ``live_mask``.

    ``group``: run this process's rank only, over a process group of the
    mesh's size (see the module docstring). Returns ``(serve, in_specs,
    out_specs)``; ``serve.statics`` is the step's full configuration.
    """
    _validate_engine_cfg(
        engine, max_bm_per_term, daat_use_kernels, daat_fused_chunk,
        daat_trips_per_launch,
    )
    axes = mesh_axes(mesh)
    dp = axes.data
    idx_spec = (("model",),)
    idx_specs = {f: idx_spec for f in _index_data_template()}
    q_spec = (dp, None)
    if live_masked:
        in_specs = (idx_specs, idx_spec, q_spec, q_spec)
    else:
        in_specs = (idx_specs, q_spec, q_spec)
    out_specs = (q_spec, q_spec)
    n_model = int(mesh.shape["model"])
    n_data = mesh.size // n_model

    statics = dict(
        engine=engine, k=k, rho_per_shard=rho_per_shard,
        max_segs_per_term=max_segs_per_term, docs_per_shard=docs_per_shard,
        scatter_impl=scatter_impl, fused_topk=fused_topk,
        daat_est_blocks=daat_est_blocks, daat_block_budget=daat_block_budget,
        max_bm_per_term=max_bm_per_term, daat_exact=daat_exact,
        daat_use_kernels=daat_use_kernels, daat_fused_chunk=daat_fused_chunk,
        daat_trips_per_launch=daat_trips_per_launch, n_docs_total=n_docs_total,
        live_masked=live_masked,
    )

    def serve(index_stack: ImpactIndex, q_terms, q_weights, live_stack=None):
        ops = _Operands(mesh, "serve step", live_masked, index_stack, q_terms,
                        q_weights, live_stack)
        if group is not None:
            rank = _check_group(mesh, group)
            drank, mrank = divmod(rank, n_model)
            pool_s, pool_i = _scan_local_shards(
                ops.data, ops.qt, ops.qw, shard_ord0=mrank, st=statics, meta_cell=ops.meta,
                live=ops.live,
            )
            lo, hi = drank * n_model, (drank + 1) * n_model  # this data group's ranks
            gs = gather_ranks(pool_s, group)[lo:hi]
            gi = gather_ranks(pool_i, group)[lo:hi]
            return canonical_topk_merge(list(gs), list(gi), k)
        out_s, out_i = [], []
        for drank in range(n_data):
            qt, qw = _rows(ops.qt, drank, n_data), _rows(ops.qw, drank, n_data)
            pools = []
            for mrank in range(n_model):
                data, live = ops.rank_rows(mrank, n_model)
                pools.append(_scan_local_shards(
                    data, qt, qw, shard_ord0=mrank, st=statics, meta_cell=ops.meta, live=live
                ))
            ms, mi = canonical_topk_merge([p[0] for p in pools], [p[1] for p in pools], k)
            out_s.append(ms)
            out_i.append(mi)
        return torch.cat(out_s), torch.cat(out_i)

    serve.statics = statics
    return serve, in_specs, out_specs


def make_pod_serve_step(
    mesh: Mesh,
    *,
    k: int,
    rho_per_shard: int,
    max_segs_per_term: int,
    docs_per_shard: int,
    scatter_impl: str = "sort",
    fused_topk: bool = False,
    engine: str = "saat",
    daat_est_blocks: int = 8,
    daat_block_budget: int = 16,
    max_bm_per_term: int = 0,
    daat_exact: bool = True,
    daat_use_kernels: bool = False,
    daat_fused_chunk: bool = False,
    daat_trips_per_launch: int = 1,
    n_docs_total: Optional[int] = None,
    live_masked: bool = False,
    group: Optional[dist.ProcessGroup] = None,
):
    """Multi-host pod serve: every host's query block, every rank's shards.

    The mesh carries a ``"pod"`` axis (one position per ingestion host) in
    the data group beside ``"model"``; the stack's shard axis is split over
    all mesh axes, pod-major, so the whole pod is one document-sharded
    replica set. Each host contributes its own ``B_local`` block (the query
    batch is split over the data group); every rank

      1. gathers the query blocks over the data group: the global
         ``[hosts * B_local, Lq]`` batch, so every shard answers every query;
      2. searches its local shards (:func:`_scan_local_shards`: identical
         rho-budgeted work a rank for SAAT);
      3. joins the id-canonical k-merge over ``data axes + ("model",)``, so
         ties and pad sentinels resolve as the unsharded oracle's do at any
         host/shard layout;
      4. hands back its own host's ``B_local`` rows.

    In process, ``serve`` takes the global batch (all hosts' blocks,
    pod-major) and returns the global answer; over ``group``, a rank's host
    block and that block's answer. Returns ``(serve, in_specs,
    out_specs)``; ``serve.statics`` adds the pod identity to the sharded
    step's (``pod_axes``, ``pod_hosts``, ``pod_model_ranks`` and
    ``merge_fanin``, the candidates entering the merge).
    """
    _validate_engine_cfg(
        engine, max_bm_per_term, daat_use_kernels, daat_fused_chunk,
        daat_trips_per_launch,
    )
    if "pod" not in mesh.axis_names:
        raise ValueError(
            f"pod serve step needs a 'pod' mesh axis, got {mesh.axis_names}"
        )
    if "model" not in mesh.axis_names:
        raise ValueError(
            f"pod serve step needs a 'model' mesh axis, got {mesh.axis_names}"
        )
    axes = mesh_axes(mesh)
    data_axes = tuple(axes.data)  # every non-"model" axis, "pod" included
    shard_axes = data_axes + ("model",)
    idx_spec = (shard_axes,)
    idx_specs = {f: idx_spec for f in _index_data_template()}
    q_spec = (data_axes, None)
    if live_masked:
        in_specs = (idx_specs, idx_spec, q_spec, q_spec)
    else:
        in_specs = (idx_specs, q_spec, q_spec)
    out_specs = (q_spec, q_spec)
    n_model = int(mesh.shape["model"])
    n_hosts = mesh.size // n_model
    n_ranks = mesh.size

    statics = dict(
        engine=engine, k=k, rho_per_shard=rho_per_shard,
        max_segs_per_term=max_segs_per_term, docs_per_shard=docs_per_shard,
        scatter_impl=scatter_impl, fused_topk=fused_topk,
        daat_est_blocks=daat_est_blocks, daat_block_budget=daat_block_budget,
        max_bm_per_term=max_bm_per_term, daat_exact=daat_exact,
        daat_use_kernels=daat_use_kernels, daat_fused_chunk=daat_fused_chunk,
        daat_trips_per_launch=daat_trips_per_launch, n_docs_total=n_docs_total,
        # pod identity: the same engine statics on another mesh is another
        # program (other gathers), and the merge fan-in is the serving
        # counter the host side reports per dispatch
        pod_axes=shard_axes, pod_hosts=n_hosts, pod_model_ranks=n_model,
        merge_fanin=n_hosts * n_model * k,
        live_masked=live_masked,
    )

    def serve(index_stack: ImpactIndex, q_terms, q_weights, live_stack=None):
        ops = _Operands(mesh, "pod serve step", live_masked, index_stack, q_terms,
                        q_weights, live_stack)
        if group is not None:
            rank = _check_group(mesh, group)
            drank = rank // n_model
            b_local = ops.qt.shape[0]
            # every model rank of a host holds that host's block: take model
            # rank 0's, host by host
            qt_g = gather_ranks(ops.qt, group)[::n_model].flatten(0, 1)
            qw_g = gather_ranks(ops.qw, group)[::n_model].flatten(0, 1)
            pool_s, pool_i = _scan_local_shards(
                ops.data, qt_g, qw_g, shard_ord0=rank, st=statics, meta_cell=ops.meta,
                live=ops.live,
            )
            ms, mi = canonical_topk_merge(pool_s, pool_i, k, group)
            lo, hi = drank * b_local, (drank + 1) * b_local
            return ms[lo:hi], mi[lo:hi]
        if ops.qt.shape[0] % n_hosts:
            raise ValueError(
                f"the pod batch of {ops.qt.shape[0]} rows does not split over {n_hosts} hosts"
            )
        pools = []
        for rank in range(n_ranks):
            data, live = ops.rank_rows(rank, n_ranks)
            pools.append(_scan_local_shards(
                data, ops.qt, ops.qw, shard_ord0=rank, st=statics, meta_cell=ops.meta,
                live=live,
            ))
        # every rank now holds the pod-global answer; each host's rows, in
        # host order, are the whole of it
        return canonical_topk_merge([p[0] for p in pools], [p[1] for p in pools], k)

    serve.statics = statics
    return serve, in_specs, out_specs


def make_bucketed_serve_step(
    mesh: Mesh,
    *,
    lq_buckets: Sequence[int],
    n_terms: int,
    **kwargs,
):
    """Lq-bucketed wrapper over the sharded (or pod) serve step.

    Each incoming batch is padded on the host to the smallest bucket
    covering its live terms, so short-query traffic stops paying long-query
    gather cost on every rank at once; all ranks see the same padded batch
    shape, so a rank's work stays identical across ranks. Results equal
    padding at max Lq (trailing pad slots are inert in both engines).

    A mesh with a ``"pod"`` axis routes to :func:`make_pod_serve_step`;
    otherwise :func:`make_sharded_serve_step` applies. ``serve_bucketed``
    buckets with numpy on the host; ``.inner`` is the step it dispatches
    and ``.buckets`` its widths.
    """
    from repro_torch.serving.scheduler import _host

    buckets = normalize_buckets(lq_buckets)
    step = make_pod_serve_step if "pod" in mesh.axis_names else make_sharded_serve_step
    serve, in_specs, out_specs = step(mesh, **kwargs)

    def serve_bucketed(index_stack: ImpactIndex, q_terms, q_weights, live_stack=None):
        qt, qw, _ = bucketize_batch(_host(q_terms), _host(q_weights), buckets, n_terms)
        return serve(index_stack, qt, qw, live_stack=live_stack)

    serve_bucketed.inner = serve
    serve_bucketed.buckets = buckets
    serve_bucketed.statics = serve.statics
    return serve_bucketed, in_specs, out_specs


def _index_data_dict(index: ImpactIndex) -> dict:
    return {f: getattr(index, f) for f in ARRAY_FIELDS}


def _index_data_template() -> dict:
    return {f: None for f in ARRAY_FIELDS}


def _static_meta_from(local: dict, docs_per_shard: int, meta: dict | None = None) -> dict:
    """Static metadata for a per-shard index rebuilt from the stack's rows.

    Shape-derived fields come from the local arrays; build-time constants
    (block size, quant scale/bits, seg/bm bounds) come from the real
    ``index_stack`` via ``meta``; the defaults (128/1.0/8) apply only when
    no index was seen.
    """
    n_docs_pad, tmax = local["doc_terms"].shape
    n_terms = local["term_seg_start"].shape[0] - 1
    m = meta or {}
    block_size = int(m.get("block_size", 128))
    return dict(
        n_docs=docs_per_shard,
        n_terms=n_terms,
        n_blocks=n_docs_pad // block_size,
        block_size=block_size,
        max_doc_terms=tmax,
        scale=float(m.get("scale", 1.0)),
        bits=int(m.get("bits", 8)),
        max_segs=int(m.get("max_segs", 0)),
        max_bm=int(m.get("max_bm", 0)),
    )
