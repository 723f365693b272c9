"""Wrappers around the fused DAAT chunk-step CUDA kernel (``csrc/chunk_step.cu``):
one phase-2 trip (``chunk_step_batched``) or up to N trips in one launch
(``chunk_step_multi_batched``) for a whole query batch.

The engine's state goes in as it is: the bool processed rows are read and
written by the kernel as bytes, and no axis is padded to a lane multiple.
For CPU tensors, and only for those, the wrappers run the plain versions in
``ref.py``. On a CUDA tensor the kernel runs or the call raises.

``CONTRACT`` declares the shapes the kernel is checked at and its launch
plan (:func:`launch_plan`, which both launchers take their numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.kernels import common
from repro_torch.kernels.chunk_step.ref import (
    chunk_step_batched_ref,
    chunk_step_multi_batched_ref,
)
from repro_torch.kernels.sparse_score.ops import MAX_LQ, QUERY_TABLE_SMEM, check_query_width

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
STATIC_SMEM_BUFFERS = QUERY_TABLE_SMEM + (("scalars", 32),)
STATIC_SMEM = sum(b for _, b in STATIC_SMEM_BUFFERS)


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


def launch_plan(batch: int, nb: int, k: int, lq: int, tmax: int, budget: int, block_size: int,
                n_live: int, trips: int | None, n_sms: int) -> common.LaunchPlan:
    """The launch of one trip (``trips`` None) or of up to ``trips`` trips:
    a cluster of ``cluster_size`` CTAs a query, ``chunk_step_layout``'s
    dynamic shared memory, the query table and a few scalars static."""
    return _plan(batch, nb, k, lq, tmax, budget, block_size, n_live, trips,
                 cluster_size(batch, n_sms))


@functools.lru_cache(maxsize=1024)
def _plan(batch, nb, k, lq, tmax, budget, block_size, n_live, trips, cluster) -> common.LaunchPlan:
    lay = chunk_step_layout(nb, k, budget, block_size)
    n_cand = budget * block_size
    head = (batch, nb, k, lq, tmax, budget, block_size, n_live)
    tail = (lay["list_len"], lay["n_keys"], cluster, lay["smem"])
    if trips is None:
        symbol, ints = "chunk_step_launch", head + tail
    else:
        symbol, ints = "chunk_step_multi_launch", head + (trips,) + tail
    return common.LaunchPlan(
        "chunk_step", symbol, "chunk_step_kernel", ints, grid=(batch * cluster, 1, 1),
        threads=THREADS, cluster=cluster,
        smem=((f"keys u64[{lay['n_keys']}]", 8 * lay["n_keys"]),
              (f"selected keys u64[{budget}]", 8 * budget), (f"bounds f32[{nb}]", 4 * nb),
              (f"candidate scores f32[{n_cand}]", 4 * n_cand),
              (f"pool (f32, i32)[{k}]", 8 * k), (f"selected blocks i32[{budget}]", 4 * budget),
              (f"processed u8[{nb}]", nb), (f"live blocks u8[{budget}]", budget)),
        static_smem=STATIC_SMEM_BUFFERS,
        cover=(("x", batch, 1),))


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
    plan = launch_plan(B, nb, k, lq, tmax, block_budget, block_size, n_live,
                       None if trips_left is None else trips, common.sm_count(ub.get_device()))
    out_s, out_i = torch.empty_like(ps), torch.empty_like(pi)
    out_th, out_proc = torch.empty_like(th), torch.empty_like(proc)
    head = [t.data_ptr() for t in (ub, proc, ps, pi, th, qt, qw, dt, dw)]
    head.append(None if live is None else live.data_ptr())
    outs = [t.data_ptr() for t in (out_s, out_i, out_th, out_proc)]
    if trips_left is None:
        n_ptrs = 14
        ptrs = head + outs
        result = (out_s, out_i, out_th, out_proc)
    else:
        n_ptrs = 16
        trips_done = torch.empty((B,), dtype=torch.int32, device=ub.device)
        ptrs = head + [trips_left.data_ptr()] + outs + [trips_done.data_ptr()]
        result = (out_s, out_i, out_th, out_proc, trips_done)
    if B:
        common.launch("chunk_step", plan.symbol, n_ptrs, tuple(ptrs) + plan.ints,
                      ub.get_device())
        if trips_left is None:
            LAUNCHES += 1
        else:
            MULTI_LAUNCHES += 1
    return result


def _event_ints(state, block_budget, block_size, n_live) -> tuple:
    """(B, nb, k, lq, tmax, budget, block size, n_live): what a launch is
    planned from."""
    dt, _, qt, _, ub, _, ps = state[:7]
    return (*ub.shape, ps.shape[1], qt.shape[1], dt.shape[1], block_budget, block_size, n_live)


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
    return common.run_kernel("chunk_step", _event_ints(state, block_budget, block_size, n_live),
                             state[4], lambda: chunk_step_batched_ref(*state, live=live, **kw),
                             lambda: _launch(state, live, None, 1, **kw))


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
    return common.run_kernel(
        "chunk_step_multi",
        _event_ints(state, block_budget, block_size, n_live) + (trips_per_launch,), state[4],
        lambda: chunk_step_multi_batched_ref(*state, trips_left, trips_per_launch=trips_per_launch,
                                             live=live, **kw),
        lambda: _launch(state, live, trips_left, trips_per_launch, **kw))


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    nb = -(-dims["n_docs"] // dims["block_size"])
    return [launch_plan(dims["B"], nb, dims["k"], dims["lq"], dims["tmax"], dims["budget"],
                        dims["block_size"], dims["n_docs"], dims.get("trips"), n_sms)]


def _contract_call(dims, device):
    """One trip (or, with ``trips``, a multi-trip launch) at ``dims`` on an
    engine state made from a seed: a doc store of 40 terms laid out as
    ``build_impact_index`` lays it, bounds, a fifth of the blocks already
    processed, a sorted pool of live doc ids, theta its k-th score; with
    ``live`` a tombstone bitmap."""
    rng = np.random.default_rng(dims["B"] * 1000 + dims["budget"] * 10 + dims["k"])
    B, k, lq, bs, tmax, n_docs = (dims[n] for n in ("B", "k", "lq", "block_size", "tmax",
                                                     "n_docs"))
    vocab = 40
    nb = -(-n_docs // bs)
    dt = np.full((nb * bs, tmax), vocab, np.int32)
    dw = np.zeros((nb * bs, tmax), np.float32)
    for d, n in enumerate(rng.integers(0, tmax + 1, nb * bs)):
        dt[d, :n] = np.sort(rng.choice(vocab, n, replace=False))
        dw[d, :n] = rng.gamma(2.0, 1.0, n)
    qt = rng.integers(0, vocab, (B, lq)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, (B, lq)).astype(np.float32)
    qw[:, -1] = 0.0
    ub = rng.uniform(1.0, 10.0, (B, nb)).astype(np.float32)
    processed = rng.random((B, nb)) < 0.2
    pool_s = -np.sort(-rng.uniform(0.0, 4.0, (B, k)), axis=1).astype(np.float32)
    pool_i = np.stack([rng.choice(n_docs, k, replace=False) for _ in range(B)]).astype(np.int32)
    t = functools.partial(torch.as_tensor, device=device)
    state = tuple(t(a) for a in (dt, dw, qt, qw, ub, processed, pool_s, pool_i, pool_s[:, -1]))
    live = t(rng.random(nb * bs) < 0.7, dtype=torch.int32) if dims.get("live") else None
    kw = dict(block_budget=dims["budget"], block_size=bs, n_live=n_docs, live=live)
    if "trips" in dims:
        fn = functools.partial(chunk_step_multi_batched, trips_per_launch=dims["trips"], **kw)
        return fn, state + (t(np.full(B, dims["trips"], np.int32)),)
    return functools.partial(chunk_step_batched, **kw), state


_CASE = dict(n_docs=220, block_size=32, lq=6, tmax=8)
_CASE24 = dict(n_docs=130, block_size=24, lq=4, tmax=8)

# The reference contract's cases (same names and dims): the full B x budget
# x k cross on a 220-doc, bs = 32 index (7 blocks), the ragged bs = 24
# degenerate, the multi-trip cases, and the tombstone-bitmap variants.
CONTRACT = KernelContract(
    name="chunk_step",
    description="fused DAAT phase-2 chunk step (shared-memory select + score + merge)",
    make_call=_contract_call,
    plan=_contract_plan,
    shape_grid=tuple(
        ShapeCase(f"b{B}_budget{budget}_k{k}", dict(B=B, budget=budget, k=k, **_CASE))
        for B in (1, 3) for budget in (1, 3, 7) for k in (1, 5)
    ) + (
        ShapeCase("ragged_bs24", dict(B=2, budget=5, k=3, **_CASE24)),
    ) + tuple(
        ShapeCase(f"multi_b{B}_trips{trips}_budget{budget}",
                  dict(B=B, trips=trips, budget=budget, k=5, **_CASE))
        for B, trips, budget in ((1, 1, 3), (3, 3, 7), (2, 4, 2))
    ) + (
        ShapeCase("multi_ragged_bs24", dict(B=2, trips=2, budget=5, k=3, **_CASE24)),
        ShapeCase("live_b2_budget3", dict(B=2, budget=3, k=5, live=1, **_CASE)),
        ShapeCase("multi_live_b2_trips3", dict(B=2, trips=3, budget=3, k=5, live=1, **_CASE)),
    ),
)
