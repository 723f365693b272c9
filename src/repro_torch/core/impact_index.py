"""Impact-ordered inverted index as a frozen dataclass of tensors.

The port of ``repro.core.impact_index``. The build is the reference's numpy
build, line for line, so every field is array-equal to the reference; only
the last step differs: the arrays are placed on a device as tensors.

Structures:
  * posting store     ``doc_ids[P]`` ordered by (term, impact desc, doc asc)
  * segment table     ``seg_{term,weight,start,len}[S]`` (term-impact runs)
  * per-term CSR      over segments and over raw postings
  * block-max table   per (term, doc-block) max weight, CSR by term
  * doc-major store   padded ``doc_terms/doc_weights[n_docs_pad, Tmax]`` used
                      by the exhaustive evaluator
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.quantization import QuantConfig, dequantize, quantize
from repro_torch.device import resolve_device


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    if x.shape[0] >= n:
        return x[:n]
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# The tensor fields of ImpactIndex, in the reference's order.
ARRAY_FIELDS = (
    "doc_ids",
    "seg_term",
    "seg_weight",
    "seg_start",
    "seg_len",
    "term_seg_start",
    "term_seg_count",
    "term_post_count",
    "term_max_weight",
    "bm_block",
    "bm_weight",
    "term_bm_start",
    "term_bm_count",
    "doc_terms",
    "doc_weights",
    "doc_n_terms",
    "doc_weight_sum",
)

# Static (non-tensor) fields, as in the reference.
META_FIELDS = (
    "n_docs",
    "n_terms",
    "n_blocks",
    "block_size",
    "max_doc_terms",
    "scale",
    "bits",
    "max_segs",
    "max_bm",
)


@dataclasses.dataclass(frozen=True)
class ImpactIndex:
    """Impact-ordered index over a corpus of sparse vectors (see module doc)."""

    # --- posting store (impact order) ---
    doc_ids: torch.Tensor  # i32[P]
    # --- segment table ---
    seg_term: torch.Tensor  # i32[S]
    seg_weight: torch.Tensor  # f32[S] dequantized impact
    seg_start: torch.Tensor  # i32[S]
    seg_len: torch.Tensor  # i32[S]
    # --- per-term CSR ---
    term_seg_start: torch.Tensor  # i32[V+1]
    term_seg_count: torch.Tensor  # i32[V+1]
    term_post_count: torch.Tensor  # i32[V+1]
    term_max_weight: torch.Tensor  # f32[V+1]
    # --- block-max structure ---
    bm_block: torch.Tensor  # i32[NB]
    bm_weight: torch.Tensor  # f32[NB]
    term_bm_start: torch.Tensor  # i32[V+1]
    term_bm_count: torch.Tensor  # i32[V+1]
    # --- doc-major store ---
    doc_terms: torch.Tensor  # i32[n_docs_pad, Tmax] (pad slot = V)
    doc_weights: torch.Tensor  # f32[n_docs_pad, Tmax]
    doc_n_terms: torch.Tensor  # i32[n_docs_pad]
    doc_weight_sum: torch.Tensor  # f32[n_docs_pad] quantized-impact sum
    # --- static metadata ---
    n_docs: int
    n_terms: int
    n_blocks: int
    block_size: int
    max_doc_terms: int
    scale: float
    bits: int
    # Largest per-term segment count (static SAAT plan bound); 0 = unknown.
    max_segs: int = 0
    # Largest per-term block-max list length; 0 = unknown.
    max_bm: int = 0

    @property
    def device(self) -> torch.device:
        return self.doc_ids.device

    @property
    def n_postings(self) -> int:
        return int(self.doc_ids.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_term.shape[0])

    def to(self, device: str | torch.device) -> "ImpactIndex":
        """The same index with every tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in ARRAY_FIELDS}
        )

    def nbytes(self) -> int:
        """Uncompressed index size (posting store + tables), bytes."""
        return sum(getattr(self, f).nbytes for f in ARRAY_FIELDS)

    def posting_store_nbytes(self) -> int:
        """Size of the inverted-file part only (Table 1 'Index Size' analogue)."""
        parts = ("doc_ids", "seg_term", "seg_weight", "seg_start", "seg_len",
                 "bm_block", "bm_weight")
        return sum(getattr(self, f).nbytes for f in parts)


def index_from_numpy(
    arrays: dict[str, np.ndarray],
    meta: dict,
    device: str | torch.device | None = None,
) -> ImpactIndex:
    """Build an :class:`ImpactIndex` from host arrays and metadata.

    ``arrays`` maps each name in ``ARRAY_FIELDS`` to a numpy array (for
    instance ``np.asarray`` of each field of a reference index) and ``meta``
    each name in ``META_FIELDS`` to its value.
    """
    dev = resolve_device(device)
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"missing index arrays: {sorted(missing)}")
    tensors = {  # np.require copies only arrays that are read-only or not C-ordered
        f: torch.from_numpy(np.require(arrays[f], requirements=("C", "W"))).to(dev)
        for f in ARRAY_FIELDS
    }
    statics = {f: meta[f] for f in META_FIELDS if f in meta}
    return ImpactIndex(**tensors, **statics)


def _build_arrays(
    doc_idx, term_idx, weights, n_docs, n_terms, quant, block_size,
    pad_postings_to, max_doc_terms, quant_max_weight,
) -> tuple[dict[str, np.ndarray], dict]:
    """The reference's host-side numpy build: (arrays, meta)."""
    doc_idx = np.asarray(doc_idx, dtype=np.int64)
    term_idx = np.asarray(term_idx, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    keep = weights > 0
    doc_idx, term_idx, weights = doc_idx[keep], term_idx[keep], weights[keep]
    if doc_idx.size == 0:
        # Degenerate but legal: a shard whose doc range holds no postings.
        # Every CSR count is zero, so the engines touch nothing, but the
        # posting/segment/block-max stores still get padded rows so no
        # zero-length array reaches a gather.
        _, scale = quantize(weights, quant, max_weight=quant_max_weight)
        max_doc_terms = max(1, max_doc_terms or 1)
        n_docs_pad = _round_up(max(n_docs, 1), block_size)
        zc = np.zeros(n_terms + 1, dtype=np.int32)
        arrays = dict(
            doc_ids=np.zeros(max(pad_postings_to, 1), dtype=np.int32),
            seg_term=np.full(1, n_terms, dtype=np.int32),
            seg_weight=np.zeros(1, dtype=np.float32),
            seg_start=np.zeros(1, dtype=np.int32),
            seg_len=np.zeros(1, dtype=np.int32),
            term_seg_start=zc,
            term_seg_count=zc.copy(),
            term_post_count=zc.copy(),
            term_max_weight=np.zeros(n_terms + 1, dtype=np.float32),
            bm_block=np.zeros(1, dtype=np.int32),
            bm_weight=np.zeros(1, dtype=np.float32),
            term_bm_start=zc.copy(),
            term_bm_count=zc.copy(),
            doc_terms=np.full((n_docs_pad, max_doc_terms), n_terms, dtype=np.int32),
            doc_weights=np.zeros((n_docs_pad, max_doc_terms), dtype=np.float32),
            doc_n_terms=np.zeros(n_docs_pad, dtype=np.int32),
            doc_weight_sum=np.zeros(n_docs_pad, dtype=np.float32),
        )
        meta = dict(
            n_docs=int(n_docs), n_terms=int(n_terms),
            n_blocks=int(n_docs_pad // block_size), block_size=int(block_size),
            max_doc_terms=int(max_doc_terms), scale=float(scale),
            bits=int(quant.bits), max_segs=0, max_bm=0,
        )
        return arrays, meta

    # -- deduplicate (doc, term) pairs by summing weights (bag-of-words) --
    key = doc_idx * n_terms + term_idx
    order = np.argsort(key, kind="stable")
    key, doc_idx, term_idx, weights = key[order], doc_idx[order], term_idx[order], weights[order]
    uk, inv = np.unique(key, return_inverse=True)
    if uk.size != key.size:
        w = np.zeros(uk.size, dtype=np.float64)
        np.add.at(w, inv, weights)
        doc_idx = (uk // n_terms).astype(np.int64)
        term_idx = (uk % n_terms).astype(np.int64)
        weights = w

    # -- quantize to impacts (a caller-supplied max keeps sharded indexes on
    # one shared impact grid so cross-shard score merges are exact) --
    q, scale = quantize(weights, quant, max_weight=quant_max_weight)
    deq = dequantize(q, scale, quant).astype(np.float32)

    # -- posting order: (term asc, impact desc, doc asc) --
    order = np.lexsort((doc_idx, -q, term_idx))
    t_s, q_s, d_s, w_s = term_idx[order], q[order], doc_idx[order], deq[order]
    P = t_s.size

    # -- segment runs of equal (term, impact) --
    seg_break = np.empty(P, dtype=bool)
    seg_break[0] = True
    seg_break[1:] = (t_s[1:] != t_s[:-1]) | (q_s[1:] != q_s[:-1])
    seg_start = np.flatnonzero(seg_break)
    seg_end = np.append(seg_start[1:], P)
    seg_len = (seg_end - seg_start).astype(np.int32)
    seg_term = t_s[seg_start].astype(np.int32)
    seg_weight = w_s[seg_start].astype(np.float32)

    # -- per-term CSR over segments / postings (V+1 rows: last = pad slot) --
    term_seg_count = np.zeros(n_terms + 1, dtype=np.int32)
    np.add.at(term_seg_count, seg_term, 1)
    term_seg_start = np.zeros(n_terms + 1, dtype=np.int32)
    term_seg_start[1:] = np.cumsum(term_seg_count)[:-1]
    term_post_count = np.zeros(n_terms + 1, dtype=np.int32)
    np.add.at(term_post_count, t_s.astype(np.int64), 1)
    term_max_weight = np.zeros(n_terms + 1, dtype=np.float32)
    np.maximum.at(term_max_weight, t_s.astype(np.int64), w_s)

    # -- block-max: per (term, block) max dequantized weight --
    n_blocks = _round_up(n_docs, block_size) // block_size
    blk = (d_s // block_size).astype(np.int64)
    tb_key = t_s * n_blocks + blk
    ub_key, ub_inv = np.unique(tb_key, return_inverse=True)
    bm_weight = np.zeros(ub_key.size, dtype=np.float32)
    np.maximum.at(bm_weight, ub_inv, w_s)
    bm_term = (ub_key // n_blocks).astype(np.int64)
    bm_block = (ub_key % n_blocks).astype(np.int32)
    term_bm_count = np.zeros(n_terms + 1, dtype=np.int32)
    np.add.at(term_bm_count, bm_term, 1)
    term_bm_start = np.zeros(n_terms + 1, dtype=np.int32)
    term_bm_start[1:] = np.cumsum(term_bm_count)[:-1]

    # -- doc-major store --
    d_order = np.lexsort((t_s, d_s))
    dd, tt, ww, qq = d_s[d_order], t_s[d_order], w_s[d_order], q_s[d_order]
    doc_n = np.zeros(n_docs, dtype=np.int32)
    np.add.at(doc_n, dd, 1)
    if max_doc_terms is None:
        max_doc_terms = int(doc_n.max())
    max_doc_terms = max(1, max_doc_terms)
    n_docs_pad = _round_up(max(n_docs, 1), block_size)
    doc_terms = np.full((n_docs_pad, max_doc_terms), n_terms, dtype=np.int32)
    doc_weights = np.zeros((n_docs_pad, max_doc_terms), dtype=np.float32)
    # position of each posting within its doc
    doc_offsets = np.zeros(n_docs + 1, dtype=np.int64)
    doc_offsets[1:] = np.cumsum(doc_n)
    within = np.arange(dd.size, dtype=np.int64) - doc_offsets[dd]
    ok = within < max_doc_terms  # truncate over-long docs (counted, rare)
    doc_terms[dd[ok], within[ok]] = tt[ok]
    doc_weights[dd[ok], within[ok]] = ww[ok]
    doc_weight_sum = np.zeros(n_docs_pad, dtype=np.float32)
    np.add.at(doc_weight_sum, dd, qq.astype(np.float32))

    # -- pad posting store --
    P_pad = _round_up(P, pad_postings_to)
    arrays = dict(
        doc_ids=_pad_to(d_s.astype(np.int32), P_pad, 0),
        seg_term=seg_term,
        seg_weight=seg_weight,
        seg_start=seg_start.astype(np.int32),
        seg_len=seg_len,
        term_seg_start=term_seg_start,
        term_seg_count=term_seg_count,
        term_post_count=term_post_count,
        term_max_weight=term_max_weight,
        bm_block=bm_block,
        bm_weight=bm_weight,
        term_bm_start=term_bm_start,
        term_bm_count=term_bm_count,
        doc_terms=doc_terms,
        doc_weights=doc_weights,
        doc_n_terms=_pad_to(doc_n, n_docs_pad, 0),
        doc_weight_sum=doc_weight_sum,
    )
    meta = dict(
        n_docs=int(n_docs), n_terms=int(n_terms), n_blocks=int(n_blocks),
        block_size=int(block_size), max_doc_terms=int(max_doc_terms),
        scale=float(scale), bits=int(quant.bits),
        max_segs=int(term_seg_count.max()), max_bm=int(term_bm_count.max()),
    )
    return arrays, meta


def build_impact_index(
    doc_idx: np.ndarray,
    term_idx: np.ndarray,
    weights: np.ndarray,
    n_docs: int,
    n_terms: int,
    *,
    quant: QuantConfig = QuantConfig(bits=8),
    block_size: int = 128,
    pad_postings_to: int = 128,
    max_doc_terms: int | None = None,
    quant_max_weight: float | None = None,
    device: str | torch.device | None = None,
) -> ImpactIndex:
    """Build an :class:`ImpactIndex` from COO postings on the host, then
    place it on ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    Args:
      doc_idx/term_idx/weights: parallel COO arrays, one entry per posting.
      n_docs, n_terms: corpus dimensions.
      quant: impact quantization config.
      block_size: document-block size for the block-max structure.
      pad_postings_to: pad the posting store to this multiple.
      max_doc_terms: doc-major padding width (defaults to the longest doc).
      quant_max_weight: pin the quantization grid's top weight.
    """
    dev = resolve_device(device)  # fail before the host build, not after
    arrays, meta = _build_arrays(
        doc_idx, term_idx, weights, n_docs, n_terms, quant, block_size,
        pad_postings_to, max_doc_terms, quant_max_weight,
    )
    return index_from_numpy(arrays, meta, dev)


def extract_doc_coo(
    index: ImpactIndex, live: np.ndarray | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Recover host-side COO postings ``(doc_idx, term_idx, weights)`` from
    the doc-major store, over the real (non-pad) documents. ``live``
    (optional bool/i32 ``[>= n_docs]`` bitmap; nonzero = live) drops
    tombstoned documents. Documents truncated at build time (longer than
    ``max_doc_terms``) come back truncated.
    """
    dt = index.doc_terms[: index.n_docs].cpu().numpy()
    dw = index.doc_weights[: index.n_docs].cpu().numpy()
    keep = (dt != index.n_terms) & (dw > 0)
    if live is not None:
        keep &= np.asarray(live)[: index.n_docs].astype(bool)[:, None]
    d, slot = np.nonzero(keep)
    return d.astype(np.int64), dt[d, slot].astype(np.int64), dw[d, slot].astype(np.float64)


def queries_on_device(index: ImpactIndex, q_terms, q_weights, live_mask=None):
    """Queries (tensors or arrays) and an optional tombstone bitmap as
    tensors on the index's device: what every engine entry point takes."""
    dev = index.device
    q_terms = torch.as_tensor(q_terms, device=dev)
    q_weights = torch.as_tensor(q_weights, device=dev)
    if live_mask is not None:
        live_mask = torch.as_tensor(live_mask, device=dev)
    return q_terms, q_weights, live_mask


def query_vector(
    index: ImpactIndex, q_terms: torch.Tensor, q_weights: torch.Tensor
) -> torch.Tensor:
    """Dense query vector over V+1 slots (pad slot stays 0). f32[V+1]."""
    qvec = torch.zeros(index.n_terms + 1, dtype=torch.float32, device=q_terms.device)
    safe = torch.where(q_weights > 0, q_terms, index.n_terms).long()
    qvec.index_add_(0, safe, q_weights.float())
    qvec[index.n_terms] = 0.0
    return qvec


def pad_queries(
    term_lists: list[np.ndarray],
    weight_lists: list[np.ndarray],
    max_q_terms: int,
    n_terms: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad ragged host-side queries to ``[B, max_q_terms]`` arrays."""
    B = len(term_lists)
    qt = np.full((B, max_q_terms), n_terms, dtype=np.int32)
    qw = np.zeros((B, max_q_terms), dtype=np.float32)
    for i, (t, w) in enumerate(zip(term_lists, weight_lists)):
        t = np.asarray(t, dtype=np.int32)
        w = np.asarray(w, dtype=np.float32)
        if t.size > max_q_terms:  # keep the highest-weight terms
            top = np.argsort(-w)[:max_q_terms]
            t, w = t[top], w[top]
        qt[i, : t.size] = t
        qw[i, : w.size] = w
    return qt, qw
