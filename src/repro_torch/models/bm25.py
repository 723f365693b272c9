"""BM25 weighting (paper baseline rows 1a/2a/3a/4a).

Parameters k1=0.82, b=0.68 are the paper's (tuned for MS MARCO passage
ranking, via Pyserini). Weights are document-side only; query weights are 1
(the classic "sum of matched document weights" formulation of Eq. (1)).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BM25Params:
    k1: float = 0.82
    b: float = 0.68


def bm25_weights(
    doc_idx: np.ndarray,
    term_idx: np.ndarray,
    tf: np.ndarray,
    n_docs: int,
    n_terms: int,
    params: BM25Params = BM25Params(),
) -> np.ndarray:
    """Per-posting BM25 weight w_{d,t} for COO postings."""
    doc_idx = np.asarray(doc_idx, dtype=np.int64)
    term_idx = np.asarray(term_idx, dtype=np.int64)
    tf = np.asarray(tf, dtype=np.float64)
    # document lengths (in tokens, tf-weighted) and df
    dl = np.zeros(n_docs, dtype=np.float64)
    np.add.at(dl, doc_idx, tf)
    avdl = dl.mean() if n_docs else 1.0
    df = np.zeros(n_terms, dtype=np.float64)
    np.add.at(df, term_idx, 1.0)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    k1, b = params.k1, params.b
    denom = tf + k1 * (1.0 - b + b * (dl[doc_idx] / max(avdl, 1e-9)))
    return (idf[term_idx] * tf * (k1 + 1.0) / denom).astype(np.float64)
