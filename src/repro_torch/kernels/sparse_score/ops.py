"""Wrappers around the match-and-accumulate CUDA scorer (``csrc/sparse_score.cu``).

For CPU tensors, and only for those, they run the plain version in
``ref.py``. On a CUDA tensor the kernel runs or the call raises. Unlike the
reference's wrappers they pad neither the doc axis nor the query slots: the
kernel masks its own ragged tail.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.sparse_score.ref import sparse_score_batched_ref

# Launches of the CUDA kernel since the last reset (``chip_smoke.py`` sets
# it to 0 before the main path and reads it after).
LAUNCHES = 0

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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, n), dtype=torch.float32, device=doc_terms.device)
    if B and n:
        code = fn(common.ptr(doc_terms), common.ptr(doc_weights), common.ptr(q_terms),
                  common.ptr(q_weights), common.ptr(out), B, n, tmax, lq,
                  common.stream_of(doc_terms))
        common.raise_on_error("sparse_score", code)
        LAUNCHES += 1
    return out


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
