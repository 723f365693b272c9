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
"""
from __future__ import annotations

import ctypes

import torch

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

# Query slots the kernels keep in shared memory (MAX_LQ in score_common.cuh).
MAX_LQ = 256


def check_query_width(lq: int) -> None:
    if lq > MAX_LQ:
        raise ValueError(f"queries of {lq} slots exceed the kernels' {MAX_LQ}")


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
    lib = common.kernel_library("sparse_score")
    fn = lib.sparse_score_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, n), dtype=torch.float32, device=doc_terms.device)
    if B and n:
        code = fn(common.ptr(doc_terms), common.ptr(doc_weights), common.ptr(q_terms),
                  common.ptr(q_weights), common.ptr(out), B, n, tmax, lq, GATHERED_DOCS_PER_CTA,
                  common.stream_of(doc_terms))
        common.raise_on_error("sparse_score", code)
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
    span = docs_per_cta(B, n, torch.cuda.get_device_properties(doc_terms.device).multi_processor_count)
    lib = common.kernel_library("sparse_score")
    fn = lib.sparse_score_blocks_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, n), dtype=torch.float32, device=doc_terms.device)
    if B and n:
        none = ctypes.c_void_p(None)
        code = fn(common.ptr(doc_terms), common.ptr(doc_weights), common.ptr(block_ids),
                  none if live is None else common.ptr(live),
                  none if block_live is None else common.ptr(block_live),
                  common.ptr(q_terms), common.ptr(q_weights), common.ptr(out),
                  B, nb, block_size, n_live, tmax, lq, span, common.stream_of(doc_terms))
        common.raise_on_error("sparse_score_blocks", code)
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
    if doc_terms.device.type == "cpu":
        return sparse_score_blocks_ref(*args, **kw)
    return sparse_score_blocks_launch(*args, **kw)


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
    if doc_terms.device.type == "cpu":
        return sparse_score_batched_ref(*args)
    return sparse_score_launch(*args)


def sparse_score(
    doc_terms: torch.Tensor,
    doc_weights: torch.Tensor,
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
) -> torch.Tensor:
    """Scores for ``[N, Tmax]`` doc rows against one ``[Lq]`` query: a batch
    of one. f32[N]."""
    return sparse_score_batched(doc_terms[None], doc_weights[None], q_terms[None], q_weights[None])[0]
