"""Block-max document-at-a-time (DAAT) search, natively batched.

The port of ``repro.core.daat``. The engine works at document-block
granularity, where Block-Max WAND gets its skipping power:

  phase 0   an upper bound for every block, one scatter-add over the
            per-term block-max lists (``ub[b] = sum_t qw_t * blockmax[t, b]``)
  phase 1   score the ``est_blocks`` highest-bound blocks exactly; theta is
            the k-th best score
  phase 2   skip every block with ``ub <= theta`` and score the survivors in
            chunks of ``block_budget`` until rank-safe (``exact=True``) or
            for one chunk (``exact=False``).

With skewed (BM25-like) weights few blocks survive and phase 2 ends at
once; with the flat "wacky" learned weights the bounds are loose and it
runs toward exhaustive scoring. ``WorkStats`` counts that collapse.

``daat_search_batched`` runs a ``[B, Lq]`` batch as one: one phase-0 pass,
one phase-1 pass, and one phase-2 loop whose state holds every query's
pool, processed set, theta and trip count side by side. Each trip checks
``active.any()`` on the host (one device sync per trip) and masks the rows
that are done, which keep their state bit for bit, so each query advances
as it would alone (``daat_search_vmap``, the per-query oracle).

``use_kernels=True`` routes phase 0 through the ``block_prune_csr`` kernel,
block selection through ``block_topk`` and scoring through ``sparse_score``
(split mode); ``fused_chunk=True`` runs each phase-2 trip as one
``chunk_step`` launch, and ``trips_per_launch=N`` runs up to N trips per
launch. The plain mode (``use_kernels=False``) is the parity oracle: every
mode gives the same ids and ``WorkStats``, and scores to f32 rounding. On
CPU tensors the kernel modes run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.impact_index import ImpactIndex, queries_on_device, query_vector
from repro_torch.core.topk import merge_topk, topk
from repro_torch.kernels.block_prune_csr import ops as prune_ops
from repro_torch.kernels.block_topk import ops as topk_ops
from repro_torch.kernels.chunk_step import ops as chunk_ops
from repro_torch.kernels.sparse_score import ops as score_ops

NEG_INF = float("-inf")


class WorkStats(NamedTuple):
    """Per-query DAAT work counts: the paper's skipping-collapse evidence."""

    n_survivors: torch.Tensor  # i32[...] blocks with ub > theta after phase 1
    blocks_scored: torch.Tensor  # i32[...] blocks scored in all
    chunks: torch.Tensor  # i32[...] phase-2 trips (tail-latency proxy)
    rank_safe: torch.Tensor  # bool[...] every survivor was scored


class DaatResult(NamedTuple):
    scores: torch.Tensor  # f32[..., k]
    doc_ids: torch.Tensor  # i32[..., k]
    n_survivors: torch.Tensor
    blocks_scored: torch.Tensor
    chunks: torch.Tensor
    rank_safe: torch.Tensor

    @property
    def stats(self) -> WorkStats:
        return WorkStats(self.n_survivors, self.blocks_scored, self.chunks, self.rank_safe)


class DaatPlan(NamedTuple):
    """Phase-0 output for ``[Lq]`` or ``[B, Lq]`` queries."""

    ub: torch.Tensor  # f32[..., n_blocks] additive block upper bounds
    qvec: torch.Tensor  # f32[..., n_terms + 1] dense query vector (pad slot 0)


def max_blocks_per_term(index: ImpactIndex) -> int:
    """Bound on a term's block-max list length (``index.max_bm`` from the
    build; reduced from the index otherwise). At least 1."""
    if index.max_bm > 0:
        return int(index.max_bm)
    return max(1, int(index.term_bm_count.max()))


def query_vectors(index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor) -> torch.Tensor:
    """Dense query vectors over V+1 slots for ``[Lq]`` or ``[B, Lq]`` inputs:
    duplicate terms sum in slot order, the pad slot stays 0."""
    if q_terms.ndim == 1:
        return query_vector(index, q_terms, q_weights)
    width = index.n_terms + 1
    B = q_terms.shape[0]
    safe = torch.where(q_weights > 0, q_terms, index.n_terms).long()
    keys = safe + torch.arange(B, device=safe.device)[:, None] * width
    qvec = torch.zeros(B * width, dtype=torch.float32, device=safe.device)
    qvec.index_add_(0, keys.reshape(-1), q_weights.float().reshape(-1))
    qvec = qvec.view(B, width)
    qvec[:, index.n_terms] = 0.0
    return qvec


def csr_blockmax_offsets(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot windows ``(base, cnt) i32[..., Lq]`` into the CSR block-max
    lists: pad and zero-weight slots map to the sentinel term's empty list,
    counts clamp to ``max_bm_per_term``."""
    t = torch.where(q_weights > 0, q_terms, index.n_terms).long()
    base = index.term_bm_start[t].to(torch.int32)
    cnt = torch.clamp_max(index.term_bm_count[t], max_bm_per_term).to(torch.int32)
    return base, cnt


def _gather_blockmax_lists(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(blocks i64, w f32)[..., Lq, M]``: each slot's block-max list, raw
    maxima (query weight not applied), invalid entries zeroed."""
    base, cnt = csr_blockmax_offsets(index, q_terms, q_weights, max_bm_per_term)
    offs = torch.arange(max_bm_per_term, dtype=torch.int32, device=base.device)
    idx = base[..., None] + offs
    valid = offs < cnt[..., None]
    idx = torch.where(valid, idx, 0).long()
    blocks = torch.where(valid, index.bm_block[idx], 0).long()
    w = torch.where(valid, index.bm_weight[idx], 0.0)
    return blocks, w


def block_upper_bounds(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> torch.Tensor:
    """BMW-style additive bound of every block: ``f32[n_blocks]`` for ``[Lq]``
    inputs, ``f32[B, n_blocks]`` for ``[B, Lq]``.

    One scatter-add per query slot, in slot order. A block appears at most
    once in a term's list, so within a slot no bound is added to twice (the
    zeroed invalid entries add 0), and every bound is summed slot by slot on
    any device: equal bit for bit to the reference's scatter-add and to the
    ``block_prune_csr`` kernel, also on the card, where ``index_add_`` has
    no fixed order among colliding adds."""
    blocks, w = _gather_blockmax_lists(index, q_terms, q_weights, max_bm_per_term)
    w = w * q_weights[..., None].float()
    nb = index.n_blocks
    one = blocks.ndim == 2
    if one:
        blocks, w = blocks[None], w[None]
    B = blocks.shape[0]
    keys = blocks + torch.arange(B, device=w.device)[:, None, None] * nb
    ub = torch.zeros(B * nb, dtype=torch.float32, device=w.device)
    for l in range(blocks.shape[1]):
        ub.index_add_(0, keys[:, l].reshape(-1), w[:, l].reshape(-1))
    ub = ub.view(B, nb)
    return ub[0] if one else ub


def _dense_blockmax_rows(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> torch.Tensor:
    """Densify the per-(query, slot) block-max lists: ``f32[B, Lq, n_blocks]``.

    Raw block maxima (query weight not applied): the ``[Lq, NB]`` layout
    the dense ``block_prune`` kernel contracts with ``q_weights``. Pad and
    zero-weight slots densify to empty rows, so they add exactly 0 to the
    bound, as in :func:`block_upper_bounds`. The layout is ``Lq`` times the
    size of the CSR lists, which is why phase 0 runs off the lists
    (``block_prune_csr``); this is the dense kernel's input, for its oracle
    role. A block appears at most once in a slot's list and the invalid
    entries add 0, so the scatter is exact in any order.
    """
    blocks, w = _gather_blockmax_lists(index, q_terms, q_weights, max_bm_per_term)
    B, lq = q_terms.shape
    nb = index.n_blocks
    rows = torch.arange(B * lq, device=w.device).view(B, lq, 1) * nb
    dense = torch.zeros(B * lq * nb, dtype=torch.float32, device=w.device)
    dense.index_add_(0, (rows + blocks).reshape(-1), w.reshape(-1))
    return dense.view(B, lq, nb)


def daat_plan(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor, max_bm_per_term: int
) -> DaatPlan:
    """Phase 0 for a whole batch: block upper bounds and dense query vectors."""
    return DaatPlan(
        ub=block_upper_bounds(index, q_terms, q_weights, max_bm_per_term),
        qvec=query_vectors(index, q_terms, q_weights),
    )


def score_blocks(
    index: ImpactIndex,
    qvec: torch.Tensor,
    block_ids: torch.Tensor,
    live_mask: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scores of whole blocks from the doc-major store.

    ``qvec[V+1], block_ids[nb]`` give ``(scores, doc_ids)[nb, block_size]``;
    ``qvec[B, V+1], block_ids[B, nb]`` give ``[B, nb, block_size]``. Pad docs
    and docs whose ``live_mask`` entry is 0 score ``-inf`` (masked after the
    sum, so the other docs' scores do not depend on the mask).
    """
    bs = index.block_size
    docs = block_ids.long()[..., None] * bs + torch.arange(bs, device=block_ids.device)
    terms = index.doc_terms[docs].long()  # [..., nb, bs, Tmax]
    w = index.doc_weights[docs]
    if qvec.ndim == 1:
        qv = qvec[terms]
    else:
        rows = torch.arange(qvec.shape[0], device=qvec.device)[:, None, None, None]
        qv = qvec[rows, terms]
    scores = torch.sum(qv * w, dim=-1)
    scores = torch.where(docs < index.n_docs, scores, NEG_INF)
    if live_mask is not None:
        scores = torch.where(live_mask[docs] != 0, scores, NEG_INF)
    return scores, docs


def _score_blocks_kernel_batched(
    index: ImpactIndex,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    block_ids: torch.Tensor,
    live_mask: torch.Tensor | None = None,
    block_live: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_blocks` through one ``sparse_score`` launch that reads
    the selected blocks' rows where they lie in the doc-major store (the
    reference gathers them outside Pallas; the function is the same and no
    ``[B, N, Tmax]`` copy is made). Pad and tombstoned docs, and the docs of
    blocks whose optional ``block_live [B, nb]`` entry is False, score
    ``-inf``."""
    bs = index.block_size
    docs = block_ids.long()[..., None] * bs + torch.arange(bs, device=block_ids.device)
    # the engine defines qw <= 0 slots as padding; the kernel sums raw weights
    qw = torch.where(q_weights > 0, q_weights.float(), 0.0)
    scores = score_ops.sparse_score_blocks_batched(
        index.doc_terms, index.doc_weights, block_ids, q_terms, qw,
        block_size=bs, n_live=index.n_docs, live=live_mask, block_live=block_live)
    return scores.reshape(docs.shape), docs


def _mask_dead_blocks(index: ImpactIndex, ub: torch.Tensor, live_mask: torch.Tensor) -> torch.Tensor:
    """``ub -> -inf`` for blocks whose every doc is tombstoned, in every mode,
    right after phase 0: such a block can yield no candidate."""
    blk_live = (live_mask != 0).reshape(index.n_blocks, index.block_size).any(dim=-1)
    return torch.where(blk_live, ub, NEG_INF)


def _resolve_daat_shapes(
    index: ImpactIndex, k: int, est_blocks: int, block_budget: int, max_chunks: int | None
) -> Tuple[int, int, int]:
    n_blocks = index.n_blocks
    est_blocks = min(est_blocks, n_blocks)
    block_budget = min(block_budget, n_blocks)
    if max_chunks is None:
        max_chunks = -(-n_blocks // block_budget)  # ceil: worst case scores all
    if k > est_blocks * index.block_size:
        raise ValueError(
            f"k={k} exceeds the phase-1 pool (est_blocks={est_blocks} * "
            f"block_size={index.block_size}); raise est_blocks"
        )
    return est_blocks, block_budget, max_chunks


def _daat_one(index, qt, qw, *, k, est_blocks, block_budget, max_bm_per_term, exact,
              max_chunks, live_mask):
    """One query through phases 0-2 (the body of :func:`daat_search_vmap`)."""
    qvec = query_vector(index, qt, qw)
    ub = block_upper_bounds(index, qt, qw, max_bm_per_term)
    if live_mask is not None:
        ub = _mask_dead_blocks(index, ub, live_mask)
    _, b1 = topk(ub, est_blocks)
    s1, d1 = score_blocks(index, qvec, b1, live_mask)
    pool_s, pos = topk(s1.reshape(-1), k)
    pool_i = d1.reshape(-1)[pos].to(torch.int32)
    theta = pool_s[k - 1]
    processed = torch.zeros(index.n_blocks, dtype=torch.bool, device=ub.device)
    processed[b1] = True
    survivors0 = ((ub > theta) & ~processed).sum().to(torch.int32)
    chunks = 0
    while bool(torch.where(processed, NEG_INF, ub).max() > theta) and chunks < max_chunks:
        ub_c, b_c = topk(torch.where(processed, NEG_INF, ub), block_budget)
        live = ub_c > theta
        s_c, d_c = score_blocks(index, qvec, b_c, live_mask)
        s_c = torch.where(live[:, None], s_c, NEG_INF)
        pool_s, pool_i = merge_topk(pool_s, pool_i, s_c.reshape(-1),
                                    d_c.reshape(-1).to(torch.int32), k)
        theta = pool_s[k - 1]
        processed = processed.clone()
        processed[b_c] = processed[b_c] | live
        chunks += 1
        if not exact:
            break
    rank_safe = torch.where(processed, NEG_INF, ub).max() <= theta
    return DaatResult(pool_s, pool_i, survivors0, processed.sum().to(torch.int32),
                      torch.tensor(chunks, dtype=torch.int32, device=ub.device), rank_safe)


def daat_search_vmap(
    index: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    est_blocks: int,
    block_budget: int,
    max_bm_per_term: int,
    exact: bool = True,
    max_chunks: int | None = None,
    live_mask: torch.Tensor | None = None,
) -> DaatResult:
    """Block-max DAAT one query at a time: the parity oracle of
    :func:`daat_search_batched` (the reference's ``jax.vmap`` of one query,
    as a loop). ``q_terms/q_weights: [B, Lq]``."""
    q_terms, q_weights, live_mask = queries_on_device(index, q_terms, q_weights, live_mask)
    est_blocks, block_budget, max_chunks = _resolve_daat_shapes(
        index, k, est_blocks, block_budget, max_chunks
    )
    rows = [
        _daat_one(index, qt, qw, k=k, est_blocks=est_blocks, block_budget=block_budget,
                  max_bm_per_term=max_bm_per_term, exact=exact, max_chunks=max_chunks,
                  live_mask=live_mask)
        for qt, qw in zip(q_terms, q_weights)
    ]
    return DaatResult(*(torch.stack(field) for field in zip(*rows)))


# The reference's historical name.
blockmax_search = daat_search_vmap


# The keyword arguments that shape a batched search: the serving layer's
# ``executable_key`` names a dispatch by these, as the reference names its
# jit cache entry (the reference passes this tuple to ``jax.jit``).
DAAT_STATICS = (
    "k", "est_blocks", "block_budget", "max_bm_per_term", "exact", "max_chunks",
    "use_kernels", "fused_chunk", "trips_per_launch",
)


def daat_search_batched(
    index: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    est_blocks: int,
    block_budget: int,
    max_bm_per_term: int,
    exact: bool = True,
    max_chunks: int | None = None,
    use_kernels: bool = False,
    fused_chunk: bool = False,
    trips_per_launch: int = 1,
    live_mask: torch.Tensor | None = None,
) -> DaatResult:
    """Natively batched block-max DAAT top-k. ``q_terms/q_weights: [B, Lq]``
    (tensors or arrays; they are moved to the index's device).

    ``use_kernels=True`` takes phase 0 through ``block_prune_csr``, block
    selection through ``block_topk`` and scoring through ``sparse_score``;
    ``fused_chunk=True`` (kernel mode only) runs each phase-2 trip as one
    ``chunk_step`` launch, and ``trips_per_launch=N`` (fused mode only) up to
    N trips per launch. ``exact=False`` runs at most one gated trip.

    ``live_mask`` (optional i32/bool ``[n_docs_pad]`` tombstone bitmap,
    nonzero = live, shared by the batch): fully dead blocks leave selection
    after phase 0 and dead docs score ``-inf``, in every mode.
    """
    q_terms, q_weights, live_mask = queries_on_device(index, q_terms, q_weights, live_mask)
    if q_terms.ndim != 2:
        raise ValueError(f"expected [B, Lq] query batch, got shape {tuple(q_terms.shape)}")
    if fused_chunk and not use_kernels:
        raise ValueError("fused_chunk fuses the kernel-mode chunk step; pass use_kernels=True")
    if trips_per_launch < 1:
        raise ValueError(f"trips_per_launch={trips_per_launch} must be >= 1")
    if trips_per_launch > 1 and not fused_chunk:
        raise ValueError(
            "trips_per_launch > 1 batches trips inside the fused chunk_step "
            "kernel; pass use_kernels=True, fused_chunk=True"
        )
    n_blocks = index.n_blocks
    est_blocks, block_budget, max_chunks = _resolve_daat_shapes(
        index, k, est_blocks, block_budget, max_chunks
    )
    B = q_terms.shape[0]
    dev = q_terms.device

    if use_kernels:
        base, cnt = csr_blockmax_offsets(index, q_terms, q_weights, max_bm_per_term)
        ub, _ = prune_ops.block_prune_csr_batched(
            index.bm_block, index.bm_weight, base, cnt, q_weights.float(),
            torch.full((B,), NEG_INF, device=dev),  # no threshold yet: a pure bound pass
            n_blocks=n_blocks, max_bm_per_term=max_bm_per_term,
        )

        def _select(scores, n):
            return topk_ops.block_topk_batched(scores, n)

        def _score(block_ids, block_live=None):
            return _score_blocks_kernel_batched(index, q_terms, q_weights, block_ids, live_mask,
                                                block_live)

    else:
        ub, qvec = daat_plan(index, q_terms, q_weights, max_bm_per_term)

        def _select(scores, n):
            return topk(scores, n)

        def _score(block_ids, block_live=None):  # the caller masks the blocks that are not live
            return score_blocks(index, qvec, block_ids, live_mask)

    if live_mask is not None:
        ub = _mask_dead_blocks(index, ub, live_mask)

    # ---- phase 1: seed every query's pool in one batched pass ----
    _, b1 = _select(ub, est_blocks)
    s1, d1 = _score(b1)
    pool_s, pos = topk(s1.reshape(B, -1), k)
    pool_i = torch.gather(d1.reshape(B, -1), -1, pos).to(torch.int32)
    theta = pool_s[:, k - 1]
    processed = torch.zeros((B, n_blocks), dtype=torch.bool, device=dev)
    processed.scatter_(1, b1.long(), True)
    survivors0 = ((ub > theta[:, None]) & ~processed).sum(dim=-1).to(torch.int32)

    # ---- phase 2: one loop, per-query state advances independently ----
    def remaining_ub(processed):
        return torch.where(processed, NEG_INF, ub)

    def active_rows(state):
        _, _, processed, theta, chunks = state
        return (remaining_ub(processed).amax(dim=-1) > theta) & (chunks < max_chunks)

    chunk_kw = dict(block_budget=block_budget, block_size=index.block_size,
                    n_live=index.n_docs, live=live_mask)
    # the engine defines qw <= 0 slots as padding; the kernels sum raw weights
    qw_raw = torch.where(q_weights > 0, q_weights.float(), 0.0)

    def chunk_step(pool_s, pool_i, processed, theta):
        if fused_chunk:
            return chunk_ops.chunk_step_batched(
                index.doc_terms, index.doc_weights, q_terms, qw_raw,
                ub, processed, pool_s, pool_i, theta, **chunk_kw,
            )
        ub_c, b_c = _select(remaining_ub(processed), block_budget)
        live = ub_c > theta[:, None]  # only these can change the top-k
        s_c, d_c = _score(b_c, live)  # the kernel scorer does not read the other blocks
        s_c = torch.where(live[..., None], s_c, NEG_INF)
        new_s, new_i = merge_topk(pool_s, pool_i, s_c.reshape(B, -1),
                                  d_c.reshape(B, -1).to(torch.int32), k)
        b_c = b_c.long()
        new_processed = processed.scatter(1, b_c, torch.gather(processed, 1, b_c) | live)
        return new_s, new_i, new_s[:, k - 1], new_processed

    # approximate mode runs one gated trip, so its launch stays one trip
    trip_cap = trips_per_launch if exact else 1

    def body(state, act):
        pool_s, pool_i, processed, theta, chunks = state
        if trip_cap > 1:
            trips_left = torch.where(act, torch.clamp_max(max_chunks - chunks, trip_cap), 0)
            new_s, new_i, new_theta, new_processed, trips = chunk_ops.chunk_step_multi_batched(
                index.doc_terms, index.doc_weights, q_terms, qw_raw,
                ub, processed, pool_s, pool_i, theta, trips_left,
                trips_per_launch=trip_cap, **chunk_kw,
            )
        else:
            new_s, new_i, new_theta, new_processed = chunk_step(pool_s, pool_i, processed, theta)
            trips = 1
        # rows that are done keep their state bit for bit
        return (
            torch.where(act[:, None], new_s, pool_s),
            torch.where(act[:, None], new_i, pool_i),
            torch.where(act[:, None], new_processed, processed),
            torch.where(act, new_theta, theta),
            chunks + torch.where(act, trips, 0).to(torch.int32),
        )

    state = (pool_s, pool_i, processed, theta, torch.zeros(B, dtype=torch.int32, device=dev))
    if exact:
        while True:
            act = active_rows(state)
            if not bool(act.any()):  # one host sync per trip
                break
            state = body(state, act)
    else:
        state = body(state, active_rows(state))
    pool_s, pool_i, processed, theta, chunks = state
    blocks_scored = processed.sum(dim=-1).to(torch.int32)
    rank_safe = remaining_ub(processed).amax(dim=-1) <= theta
    return DaatResult(pool_s, pool_i, survivors0, blocks_scored, chunks, rank_safe)
