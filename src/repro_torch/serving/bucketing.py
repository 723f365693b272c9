"""Lq bucketing: pad query batches to a small grid of widths, not to max Lq.

Both engines run a ``[B, Lq]`` batch as one executable, and both are
*invariant to trailing pad columns*: a pad slot (term id ``n_terms`` or
weight 0) contributes no segments to the SAAT plan and scatters nothing into
the DAAT dense query vector, and the posting gather masks invalid slots
before they touch the accumulator. Serving every batch at the width of the
longest query in the *stream* therefore wastes gather/sort work linear in
``Lq`` for short-query traffic — but serving each batch at its own exact
width would compile a fresh executable per distinct width.

The compromise is a small ladder of bucket widths: a batch whose widest
query has ``eff`` live terms is padded to the smallest bucket ``>= eff``,
so the executable grid stays ``O(|buckets|)`` per engine config while doc
ids and scores stay **bit-identical** to the max-Lq pad (asserted by the
hypothesis property suite in ``tests/test_queue.py``).

Pad-slot convention (matches ``pad_queries`` / ``saat_plan``): a slot is
live iff ``term_id != n_terms`` *and* ``weight > 0``. ``effective_lq`` is
the last live column + 1, so interior pads are never sliced away.

A copy of ``repro.serving.bucketing`` (numpy only), so the port imports
nothing of the reference. It works on host arrays: the server moves a
bucketed batch to its device afterwards.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def normalize_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
    """Sorted, deduplicated, validated bucket widths."""
    out = tuple(sorted({int(b) for b in buckets}))
    if not out or out[0] <= 0:
        raise ValueError(f"bucket widths must be positive, got {buckets!r}")
    return out


def effective_lq(q_terms: np.ndarray, q_weights: np.ndarray, n_terms: int) -> int:
    """Width of the narrowest left-slice covering every live slot (>= 1)."""
    qt = np.asarray(q_terms)
    qw = np.asarray(q_weights)
    live = (qt != n_terms) & (qw > 0)
    cols = np.nonzero(live.any(axis=tuple(range(live.ndim - 1))))[0]
    return int(cols[-1]) + 1 if cols.size else 1


def bucket_for(eff_lq: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= eff_lq (buckets ascending).

    A width that overflows the ladder rounds up to the next multiple of the
    largest bucket, so pathologically wide queries cost at most one extra
    executable per ``buckets[-1]`` step instead of one per distinct width.
    """
    for b in buckets:
        if b >= eff_lq:
            return int(b)
    top = int(buckets[-1])
    return -(-int(eff_lq) // top) * top


def pad_to_width(
    q_terms: np.ndarray, q_weights: np.ndarray, width: int, n_terms: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (or slice, when every dropped column is dead) a batch to ``width``.

    Slicing below ``effective_lq`` would drop live terms, so callers must
    pass ``width >= effective_lq(...)``; this is asserted cheaply here.
    """
    qt = np.asarray(q_terms, dtype=np.int32)
    qw = np.asarray(q_weights, dtype=np.float32)
    L = qt.shape[-1]
    if width == L:
        return qt, qw
    if width < L:
        dropped_live = (qt[..., width:] != n_terms) & (qw[..., width:] > 0)
        if dropped_live.any():
            raise ValueError(
                f"slicing [.., {L}) -> [.., {width}) would drop live query terms"
            )
        return np.ascontiguousarray(qt[..., :width]), np.ascontiguousarray(qw[..., :width])
    pad_shape = qt.shape[:-1] + (width,)
    out_t = np.full(pad_shape, n_terms, dtype=np.int32)
    out_w = np.zeros(pad_shape, dtype=np.float32)
    out_t[..., :L] = qt
    out_w[..., :L] = qw
    return out_t, out_w


def sentinel_rows(n_rows: int, width: int, n_terms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inert query rows: every slot is a pad (term id ``n_terms``, weight 0).

    A sentinel row contributes no SAAT segments and no DAAT survivors, so it
    is the free way to fill a batch to a compiled shape — the admission
    queue's short flushes and the pod front end's absent-host blocks both
    stamp real rows over this canvas. Returns ``(q_terms, q_weights)`` of
    shape ``[n_rows, width]``.
    """
    return (
        np.full((n_rows, width), n_terms, dtype=np.int32),
        np.zeros((n_rows, width), dtype=np.float32),
    )


def bucketize_batch(
    q_terms: np.ndarray,
    q_weights: np.ndarray,
    buckets: Sequence[int],
    n_terms: int,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a ``[B, Lq]`` batch to its bucket width; returns (qt, qw, bucket)."""
    eff = effective_lq(q_terms, q_weights, n_terms)
    b = bucket_for(eff, buckets)
    qt, qw = pad_to_width(q_terms, q_weights, b, n_terms)
    return qt, qw, b
