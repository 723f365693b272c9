"""Wrappers around the fused DAAT chunk-step CUDA kernel (``csrc/chunk_step.cu``):
one phase-2 trip (``chunk_step_batched``) or up to N trips in one launch
(``chunk_step_multi_batched``) for a whole query batch.

The engine's state goes in as it is: the bool processed rows are read and
written by the kernel as bytes, and no axis is padded to a lane multiple.
For CPU tensors, and only for those, the wrappers run the plain versions in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.
"""
from __future__ import annotations


import torch

from repro_torch.kernels import common
from repro_torch.kernels.chunk_step.ref import (
    chunk_step_batched_ref,
    chunk_step_multi_batched_ref,
)
from repro_torch.kernels.sparse_score.ops import MAX_LQ, check_query_width

# Launches of each CUDA kernel since the last reset (``chip_smoke.py`` sets
# them to 0 before the main path and reads them after).
LAUNCHES = 0  # one trip per launch
MULTI_LAUNCHES = 0  # up to trips_per_launch trips per launch


def _prepare(doc_terms, doc_weights, q_terms, q_weights, ub, processed, pool_s, pool_i, theta,
             block_budget, block_size, live):
    """Check the shapes and bring every input to the kernel's types."""
    B, nb = ub.shape
    if block_budget > nb:
        raise ValueError(
            f"block_budget={block_budget} exceeds n_blocks={nb}; the engine "
            "clamps budgets before the loop"
        )
    if doc_terms.shape[0] < nb * block_size:
        raise ValueError(f"the doc store holds {doc_terms.shape[0]} rows, fewer than "
                         f"n_blocks * block_size = {nb * block_size}")
    if live is not None:
        live = live.to(torch.int32)[: nb * block_size].contiguous()
    state = (
        doc_terms.to(torch.int32).contiguous(),
        doc_weights.to(torch.float32).contiguous(),
        q_terms.to(torch.int32).contiguous(),
        q_weights.to(torch.float32).contiguous(),
        ub.to(torch.float32).contiguous(),
        processed.to(torch.bool).contiguous(),
        pool_s.to(torch.float32).contiguous(),
        pool_i.to(torch.int32).contiguous(),
        theta.to(torch.float32).contiguous(),
    )
    return state, live


# Threads of a chunk_step CTA (THREADS in chunk_step.cu), the largest
# portable cluster, and the kernel's static shared memory: the query table
# (17 B a slot), the term filter and a few scalars (score_common.cuh).
THREADS = 1024
MAX_CLUSTER = 8
STATIC_SMEM = 17 * MAX_LQ + 4 * 2048 + 32


def cluster_size(batch: int, n_sms: int) -> int:
    """CTAs per query: the largest power of two up to ``MAX_CLUSTER`` that
    keeps ``batch * size`` within the card's SMs (at least 1), so a batch
    spreads over the card one CTA per SM. (Two CTAs of this kernel fit on
    an SM, but a cluster twice as wide also doubles the trip's fixed cost;
    ``chip_smoke.py`` times every size, and ``PERF.md`` records it.)"""
    size = 1
    while size < MAX_CLUSTER and 2 * size * batch <= n_sms:
        size *= 2
    return size


def chunk_step_layout(nb: int, k: int, block_budget: int, block_size: int) -> dict:
    """The kernel's launch shape for a state of ``nb`` blocks and a pool of
    ``k``: each warp's select list, the key buffer (the select lists, then
    the merge's worst case, k plus every candidate, as a power of two) and
    the dynamic shared memory of the layout at the head of
    ``chunk_step_kernel``. Raises when it does not fit."""
    n_cand = block_budget * block_size
    list_len = min(block_budget, 32 * -(-nb // THREADS))
    n_keys = max(32 * list_len, common.next_pow2(k + n_cand))
    smem = (8 * (n_keys + block_budget) + 4 * (nb + n_cand + 2 * k + block_budget)
            + nb + block_budget)
    if smem + STATIC_SMEM > common.SMEM_LIMIT:
        raise ValueError(f"the chunk state needs {smem + STATIC_SMEM} B of shared memory; the "
                         f"limit is {common.SMEM_LIMIT}")
    return dict(list_len=list_len, n_keys=n_keys, smem=smem)


def _launch(state, live, trips_left, trips, block_budget, block_size, n_live):
    """Launch one of the two kernels; returns the new state (and trips_done)."""
    global LAUNCHES, MULTI_LAUNCHES
    dt, dw, qt, qw, ub, proc, ps, pi, th = state
    tensors = state if live is None else state + (live,)
    if trips_left is not None:
        tensors = tensors + (trips_left,)
    common.check_cuda_tensors(*tensors)
    B, nb = ub.shape
    k, lq, tmax = ps.shape[1], qt.shape[1], dt.shape[1]
    check_query_width(lq)
    lay = chunk_step_layout(nb, k, block_budget, block_size)
    cluster = cluster_size(B, common.sm_count(ub.get_device()))
    out_s, out_i = torch.empty_like(ps), torch.empty_like(pi)
    out_th, out_proc = torch.empty_like(th), torch.empty_like(proc)
    head = [t.data_ptr() for t in (ub, proc, ps, pi, th, qt, qw, dt, dw)]
    head.append(None if live is None else live.data_ptr())
    outs = [t.data_ptr() for t in (out_s, out_i, out_th, out_proc)]
    dims = [B, nb, k, lq, tmax, block_budget, block_size, n_live]
    tail = [lay["list_len"], lay["n_keys"], cluster, lay["smem"]]
    if trips_left is None:
        symbol, n_ptrs = "chunk_step_launch", 14
        args = head + outs + dims + tail
        result = (out_s, out_i, out_th, out_proc)
    else:
        symbol, n_ptrs = "chunk_step_multi_launch", 16
        trips_done = torch.empty((B,), dtype=torch.int32, device=ub.device)
        args = (head + [trips_left.data_ptr()] + outs + [trips_done.data_ptr()] + dims + [trips]
                + tail)
        result = (out_s, out_i, out_th, out_proc, trips_done)
    if B:
        common.launch("chunk_step", symbol, n_ptrs, tuple(args), ub.get_device())
        if trips_left is None:
            LAUNCHES += 1
        else:
            MULTI_LAUNCHES += 1
    return result


def chunk_step_batched(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    ub: torch.Tensor,
    processed: torch.Tensor,
    pool_s: torch.Tensor,
    pool_i: torch.Tensor,
    theta: torch.Tensor,
    *,
    block_budget: int,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused phase-2 trip over the whole ``[B, ...]`` state.

    ``doc_terms``/``doc_weights``: the doc-major store ``[n_docs_pad, Tmax]``
    (each row its doc's distinct terms, then one pad term to its end, as
    ``build_impact_index`` lays it out: the kernel stops reading a row at
    its padding);
    ``q_terms``/``q_weights``: ``[B, Lq]``, weight-``<= 0`` slots zeroed;
    ``ub``: ``f32[B, n_blocks]``; ``processed``: ``bool[B, n_blocks]``;
    ``pool_s``/``pool_i``: the ``[B, k]`` pool; ``theta``: ``f32[B]``;
    ``live``: optional ``[n_docs_pad]`` tombstone bitmap (nonzero = live).
    Returns ``(pool_s, pool_i, theta, processed)``.
    """
    state, live = _prepare(doc_terms, doc_weights, q_terms, q_weights, ub, processed, pool_s,
                           pool_i, theta, block_budget, block_size, live)
    kw = dict(block_budget=block_budget, block_size=block_size, n_live=n_live)
    if ub.device.type == "cpu":
        return chunk_step_batched_ref(*state, live=live, **kw)
    return _launch(state, live, None, 1, **kw)


def chunk_step_multi_batched(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    ub: torch.Tensor,
    processed: torch.Tensor,
    pool_s: torch.Tensor,
    pool_i: torch.Tensor,
    theta: torch.Tensor,
    trips_left: torch.Tensor,
    *,
    trips_per_launch: int,
    block_budget: int,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``trips_per_launch`` fused trips in one launch.

    Same state as :func:`chunk_step_batched` plus ``trips_left: i32[B]``,
    each row's trip budget (0 freezes a row). A row stops early once its
    highest remaining bound is not above theta. Returns ``(pool_s, pool_i,
    theta, processed, trips_done)``.
    """
    if trips_per_launch < 1:
        raise ValueError(f"trips_per_launch={trips_per_launch} must be >= 1")
    state, live = _prepare(doc_terms, doc_weights, q_terms, q_weights, ub, processed, pool_s,
                           pool_i, theta, block_budget, block_size, live)
    trips_left = trips_left.to(torch.int32).contiguous()
    kw = dict(block_budget=block_budget, block_size=block_size, n_live=n_live)
    if ub.device.type == "cpu":
        return chunk_step_multi_batched_ref(*state, trips_left, trips_per_launch=trips_per_launch,
                                            live=live, **kw)
    return _launch(state, live, trips_left, trips_per_launch, **kw)
