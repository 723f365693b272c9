"""Wrappers around the match-and-accumulate CUDA scorer (``csrc/sparse_score.cu``).

Two entries share the kernel: ``sparse_score_batched`` scores gathered
``[B, N, Tmax]`` rows (the reference kernel's contract), and
``sparse_score_blocks_batched`` scores each query's selected blocks where
their rows lie in the index's doc-major store (the DAAT split mode's
scorer: no ``[B, N, Tmax]`` copy is made).

For CPU tensors, and only for those, they run the plain versions in
``ref.py``. On a CUDA tensor the kernel runs or the call raises. Unlike the
reference's wrappers they pad neither the doc axis nor the query slots: the
kernel masks its own ragged tail.

``CONTRACT`` declares the shapes the kernel is checked at and the launch
plans of both entries (:func:`launch_plan`, :func:`blocks_launch_plan`,
which the launchers take their numbers from).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import KernelContract, ShapeCase
from repro_torch.kernels import common
from repro_torch.kernels.sparse_score.ref import sparse_score_batched_ref, sparse_score_blocks_ref

# Launches of each entry since the last reset (``chip_smoke.py`` sets them
# to 0 before the main path and reads them after).
LAUNCHES = 0  # gathered rows
STORE_LAUNCHES = 0  # rows read in place from the store

# Threads of a scoring CTA (THREADS in sparse_score.cu), the CTAs of it an
# SM holds at once (2,048 threads; the kernel caps its registers for it),
# the most docs a store-addressed CTA scores (4 a warp), and the gathered
# entry's docs per CTA.
THREADS = 256
CTAS_PER_SM = 2048 // THREADS
MAX_DOCS_PER_CTA = 32
GATHERED_DOCS_PER_CTA = 64

# Query slots the kernels keep in shared memory, and the words of their
# term filter (MAX_LQ and FILTER_WORDS in score_common.cuh).
MAX_LQ = 256
FILTER_WORDS = 2048
# The static shared memory of a scoring CTA (and of chunk_step's): the
# query table (term, weight, flag, matched term and value: 17 B a slot) and
# the term filter.
QUERY_TABLE_SMEM = ((f"query table (17 B x {MAX_LQ} slots)", 17 * MAX_LQ),
                    (f"term filter u32[{FILTER_WORDS}]", 4 * FILTER_WORDS))


def check_query_width(lq: int) -> None:
    if lq > MAX_LQ:
        raise ValueError(f"queries of {lq} slots exceed the kernels' {MAX_LQ}")


@functools.lru_cache(maxsize=1024)
def launch_plan(batch: int, n: int, tmax: int, lq: int) -> common.LaunchPlan:
    """The gathered entry's launch: a CTA a (``GATHERED_DOCS_PER_CTA``
    docs, query)."""
    span = GATHERED_DOCS_PER_CTA
    return common.LaunchPlan(
        "sparse_score", "sparse_score_launch", "sparse_score_kernel<false>",
        (batch, n, tmax, lq, span), grid=(-(-n // span), batch, 1), threads=THREADS,
        static_smem=QUERY_TABLE_SMEM + (("s_n", 4),), cover=(("x", n, span), ("y", batch, 1)))


def sparse_score_launch(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
) -> torch.Tensor:
    """Launch the kernel: i32/f32 ``[B, N, Tmax]`` rows against i32/f32
    ``[B, Lq]`` queries -> f32[B, N]."""
    global LAUNCHES
    common.check_cuda_tensors(doc_terms, doc_weights, q_terms, q_weights)
    common.check_dtypes(doc_terms=(doc_terms, torch.int32), doc_weights=(doc_weights, torch.float32),
                        q_terms=(q_terms, torch.int32), q_weights=(q_weights, torch.float32))
    B, n, tmax = doc_terms.shape
    lq = q_terms.shape[1]
    if doc_weights.shape != doc_terms.shape or q_terms.shape != (B, lq) or q_weights.shape != (B, lq):
        raise ValueError("expected [B, N, Tmax] doc rows and [B, Lq] queries")
    check_query_width(lq)
    out = torch.empty((B, n), dtype=torch.float32, device=doc_terms.device)
    if B and n:
        plan = launch_plan(B, n, tmax, lq)
        common.launch("sparse_score", plan.symbol, 5,
                      (doc_terms.data_ptr(), doc_weights.data_ptr(), q_terms.data_ptr(),
                       q_weights.data_ptr(), out.data_ptr()) + plan.ints, doc_terms.get_device())
        LAUNCHES += 1
    return out


def docs_per_cta(batch: int, n: int, n_sms: int) -> int:
    """Docs a store-addressed CTA scores: ``MAX_DOCS_PER_CTA`` (4 a warp,
    which pays the CTA's query setup once per 32 docs and leaves the card
    several waves to balance), fewer (a multiple of the CTA's 8 warps, at
    least 8) where the batch's docs would not give every CTA slot of the
    card a CTA."""
    warps = THREADS // 32
    fill = -(-max(batch, 1) * n // (n_sms * CTAS_PER_SM))
    return min(MAX_DOCS_PER_CTA, max(warps, fill // warps * warps))


def blocks_launch_plan(batch: int, nb: int, block_size: int, n_live: int, tmax: int, lq: int,
                       n_sms: int) -> common.LaunchPlan:
    """The store-addressed entry's launch: a CTA a (``docs_per_cta`` docs,
    query)."""
    return _blocks_plan(batch, nb, block_size, n_live, tmax, lq,
                        docs_per_cta(batch, nb * block_size, n_sms))


@functools.lru_cache(maxsize=1024)
def _blocks_plan(batch, nb, block_size, n_live, tmax, lq, span) -> common.LaunchPlan:
    n = nb * block_size
    return common.LaunchPlan(
        "sparse_score", "sparse_score_blocks_launch", "sparse_score_kernel<true>",
        (batch, nb, block_size, n_live, tmax, lq, span), grid=(-(-n // span), batch, 1),
        threads=THREADS, static_smem=QUERY_TABLE_SMEM + (("s_n", 4),),
        cover=(("x", n, span), ("y", batch, 1)))


def sparse_score_blocks_launch(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    block_ids: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    *,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,
    block_live: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the store-addressed kernel: the store i32/f32 ``[n_docs_pad,
    Tmax]``, ``block_ids`` i32[B, nb], i32/f32 ``[B, Lq]`` queries, an
    optional i32[n_docs_pad] ``live`` bitmap and bool[B, nb] ``block_live``
    gate -> f32[B, nb * block_size]."""
    global STORE_LAUNCHES
    tensors = [t for t in (doc_terms, doc_weights, block_ids, q_terms, q_weights, live,
                           block_live) if t is not None]
    common.check_cuda_tensors(*tensors)
    common.check_dtypes(doc_terms=(doc_terms, torch.int32), doc_weights=(doc_weights, torch.float32),
                        block_ids=(block_ids, torch.int32), q_terms=(q_terms, torch.int32),
                        q_weights=(q_weights, torch.float32))
    n_docs_pad, tmax = doc_terms.shape
    B, nb = block_ids.shape
    lq = q_terms.shape[1]
    if doc_weights.shape != doc_terms.shape or q_terms.shape != (B, lq) or q_weights.shape != (B, lq):
        raise ValueError("expected an [n_docs_pad, Tmax] store, [B, nb] block ids and [B, Lq] queries")
    if n_docs_pad % block_size:
        raise ValueError(f"the store's {n_docs_pad} rows are not whole blocks of {block_size}")
    if live is not None and (live.dtype != torch.int32 or live.shape != (n_docs_pad,)):
        raise ValueError(f"live must be i32[{n_docs_pad}], got {live.dtype}{list(live.shape)}")
    if block_live is not None and (block_live.dtype != torch.bool or block_live.shape != (B, nb)):
        raise ValueError(f"block_live must be bool[{B}, {nb}], got "
                         f"{block_live.dtype}{list(block_live.shape)}")
    check_query_width(lq)
    n = nb * block_size
    out = torch.empty((B, n), dtype=torch.float32, device=doc_terms.device)
    if B and n:
        plan = blocks_launch_plan(B, nb, block_size, n_live, tmax, lq,
                                  common.sm_count(doc_terms.get_device()))
        common.launch("sparse_score", plan.symbol, 8,
                      (doc_terms.data_ptr(), doc_weights.data_ptr(), block_ids.data_ptr(),
                       None if live is None else live.data_ptr(),
                       None if block_live is None else block_live.data_ptr(),
                       q_terms.data_ptr(), q_weights.data_ptr(), out.data_ptr()) + plan.ints,
                      doc_terms.get_device())
        STORE_LAUNCHES += 1
    return out


def sparse_score_blocks_batched(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    block_ids: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    *,
    block_size: int,
    n_live: int,
    live: torch.Tensor | None = None,
    block_live: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scores of the docs of each query's selected blocks, read where they
    lie in the doc-major store ``doc_terms/doc_weights [n_docs_pad, Tmax]``
    (each row its doc's distinct terms, then one pad term to its end, as
    ``build_impact_index`` lays it out: the kernel stops reading a row at
    its padding). ``block_ids [B, nb]``, queries ``[B, Lq]``. Doc
    ``j * block_size + i`` of row b is store row ``block_ids[b, j] *
    block_size + i``; pad docs (id >= ``n_live``), docs whose ``live`` entry
    is 0 and the docs of blocks whose ``block_live`` entry is False score
    ``-inf`` and are not read. f32[B, nb * block_size]."""
    args = (
        doc_terms.to(torch.int32).contiguous(),
        doc_weights.to(torch.float32).contiguous(),
        block_ids.to(torch.int32).contiguous(),
        q_terms.to(torch.int32).contiguous(),
        q_weights.to(torch.float32).contiguous(),
    )
    kw = dict(block_size=block_size, n_live=n_live,
              live=None if live is None else live.to(torch.int32)[: doc_terms.shape[0]].contiguous(),
              block_live=None if block_live is None else block_live.to(torch.bool).contiguous())
    return common.run_kernel(
        "sparse_score_blocks",
        (*args[2].shape, block_size, n_live, doc_terms.shape[1], q_terms.shape[1]), args[0],
        lambda: sparse_score_blocks_ref(*args, **kw), lambda: sparse_score_blocks_launch(*args, **kw))


def sparse_score_batched(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
) -> torch.Tensor:
    """Per-query scores for ``doc_terms [B, N, Tmax]`` against queries
    ``[B, Lq]``: ``score_d = sum_j w_dj * sum_l [term_dj == qt_l] * qw_l``.
    Slots of weight 0 add nothing. f32[B, N]."""
    args = (
        doc_terms.to(torch.int32).contiguous(),
        doc_weights.to(torch.float32).contiguous(),
        q_terms.to(torch.int32).contiguous(),
        q_weights.to(torch.float32).contiguous(),
    )
    return common.run_kernel("sparse_score", (*args[0].shape, args[2].shape[-1]), args[0],
                             lambda: sparse_score_batched_ref(*args),
                             lambda: sparse_score_launch(*args))


def sparse_score(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
) -> torch.Tensor:
    """Scores for ``[N, Tmax]`` doc rows against one ``[Lq]`` query: a batch
    of one. f32[N]."""
    return sparse_score_batched(doc_terms[None], doc_weights[None], q_terms[None], q_weights[None])[0]


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


def _contract_plan(dims, n_sms=common.H100_SMS):
    B = dims.get("batch", 1)
    if dims.get("store"):
        return [blocks_launch_plan(B, dims["nb"], dims["block_size"], dims["n_live"],
                                   dims["tmax"], dims["lq"], n_sms)]
    return [launch_plan(B, dims["n"], dims["tmax"], dims["lq"])]


def _store_call(dims, device):
    """The store-addressed entry on a store of ``n_blocks`` blocks laid out
    as ``build_impact_index`` lays it (each row its distinct ascending
    terms, then the pad term ``vocab`` to its end), ``nb`` distinct blocks a
    query, a tombstone bitmap and a live-block gate."""
    rng = np.random.default_rng(dims["tmax"] * dims["lq"])
    n_blocks, bs, tmax, vocab = dims["n_blocks"], dims["block_size"], dims["tmax"], dims["vocab"]
    B, lq, nb = dims["batch"], dims["lq"], dims["nb"]
    dt = np.full((n_blocks * bs, tmax), vocab, np.int32)
    dw = np.zeros((n_blocks * bs, tmax), np.float32)
    for d, n in enumerate(rng.integers(0, tmax + 1, n_blocks * bs)):
        dt[d, :n] = np.sort(rng.choice(vocab, n, replace=False))
        dw[d, :n] = rng.gamma(1.0, 1.0, n)
    qt = rng.integers(0, vocab, (B, lq)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, (B, lq)).astype(np.float32)
    ids = np.stack([rng.choice(n_blocks, nb, replace=False) for _ in range(B)]).astype(np.int32)
    live = rng.random(n_blocks * bs) < 0.8
    block_live = rng.random((B, nb)) < 0.7
    t = functools.partial(torch.as_tensor, device=device)
    fn = functools.partial(sparse_score_blocks_batched, block_size=bs, n_live=dims["n_live"],
                           live=t(live, dtype=torch.int32), block_live=t(block_live))
    return fn, (t(dt), t(dw), t(ids), t(qt), t(qw))


def _contract_call(dims, device):
    """The gathered entry at ``dims`` (a 50-term vocabulary, so terms match
    often; a repeated query term and a zero-weight slot), or with ``store``
    the store-addressed one (:func:`_store_call`). The reference's
    ``block_d`` is its doc tile; the kernel here tiles the doc axis itself."""
    if dims.get("store"):
        return _store_call(dims, device)
    rng = np.random.default_rng(dims["n"] * dims["tmax"] * dims["lq"])
    B = dims.get("batch", 1)
    dt = rng.integers(0, 50, (B, dims["n"], dims["tmax"])).astype(np.int32)
    dw = rng.gamma(1.0, 1.0, dt.shape).astype(np.float32)
    qt = rng.integers(0, 50, (B, dims["lq"])).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, qt.shape).astype(np.float32)
    if dims["lq"] > 1:
        qt[:, 1] = qt[:, 0]
    if dims["lq"] > 2:
        qw[:, 2] = 0.0
    args = [dt, dw, qt, qw] if "batch" in dims else [dt[0], dw[0], qt[0], qw[0]]
    fn = sparse_score_batched if "batch" in dims else sparse_score
    return fn, tuple(torch.as_tensor(a, device=device) for a in args)


# The reference contract's cases (same names and dims), then the
# store-addressed entry on a small store whose last 5 docs are pad docs.
# (chip_smoke.py also holds that entry to the split trip's widths, B = 64,
# 16 blocks of 128 a query, Tmax 650, Lq 35: STORE_EDGE there. Its plain
# version takes about 20 s on one CPU thread, so it is not a case here.)
CONTRACT = KernelContract(
    name="sparse_score",
    description="match-and-accumulate sparse scorer (DAAT chunk scoring)",
    make_call=_contract_call,
    plan=_contract_plan,
    shape_grid=(
        ShapeCase("small", dict(n=100, tmax=16, lq=8, block_d=128)),
        ShapeCase("aligned", dict(n=512, tmax=64, lq=32, block_d=128)),
        ShapeCase("ragged", dict(n=130, tmax=7, lq=3, block_d=128)),
        ShapeCase("b1", dict(batch=1, n=100, tmax=16, lq=8, block_d=128)),
        ShapeCase("b3_ragged", dict(batch=3, n=130, tmax=7, lq=3, block_d=128)),
        ShapeCase("b4_aligned", dict(batch=4, n=512, tmax=64, lq=32, block_d=128)),
        ShapeCase("store_b3", dict(store=1, n_blocks=6, block_size=32, tmax=40, vocab=200,
                                   batch=3, lq=8, nb=4, n_live=6 * 32 - 5), port=True),
    ),
)
