"""The concept-latent synthetic corpus, vectorized, for the benchmark's set-up.

A frozen copy of the port's ``data/synthetic.py`` generative story (Zipf
concept popularity, Zipf surface forms inside a concept, stopwords, a query
written about a focus document's central concepts with its surface forms
drawn again, so vocabulary mismatch is built in). The port draws each
document in a Python loop; at a 276,307-document shard that loop alone
takes over a minute of every run's set-up. Here the documents are drawn in
a few whole-corpus numpy calls from the same distributions, so the corpus
has the same statistics but not the same bytes as the port's for a seed.
``test_portbench_data.py`` holds the two to each other at a small size.

Sorting, the only step above linear time, goes through ``argsort``, which
callers point at the card (a stable sort gives the same permutation on
every device, so a seed gives the same corpus everywhere).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


def np_argsort(keys: np.ndarray) -> np.ndarray:
    return np.argsort(keys, kind="stable")


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 20000
    n_queries: int = 200
    n_concepts: int = 2000
    terms_per_concept: int = 24
    n_stopwords: int = 64
    concepts_per_doc: float = 6.0
    terms_per_doc_concept: float = 4.0
    stopwords_per_doc: float = 6.0
    concepts_per_query: float = 2.0
    terms_per_query_concept: float = 1.3
    stopwords_per_query: float = 0.8
    concept_zipf: float = 1.1
    term_zipf: float = 1.2
    max_tf: int = 8
    seed: int = 0

    @property
    def n_surface_terms(self) -> int:
        return self.n_stopwords + self.n_concepts * self.terms_per_concept


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Documents as CSR over (surface term, tf); each document's concepts as
    CSR too, in drawing order (the first is the most central)."""

    config: CorpusConfig
    doc_offsets: np.ndarray  # i64[n_docs + 1]
    doc_terms: np.ndarray  # i32[nnz]
    doc_tfs: np.ndarray  # i32[nnz]
    concept_offsets: np.ndarray  # i64[n_docs + 1]
    concepts: np.ndarray  # i32[n_doc_concepts]
    strengths: np.ndarray  # f32[n_doc_concepts]
    query_terms: list
    query_concepts: list
    qrels: np.ndarray  # i32[n_queries]

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_queries(self) -> int:
        return len(self.query_terms)

    def doc(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.doc_offsets[i], self.doc_offsets[i + 1]
        return self.doc_terms[lo:hi], self.doc_tfs[lo:hi]

    def doc_concepts(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.concept_offsets[i], self.concept_offsets[i + 1]
        return self.concepts[lo:hi], self.strengths[lo:hi]

    def coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(doc_idx, term_idx, tf) postings."""
        doc_idx = np.repeat(np.arange(self.n_docs, dtype=np.int64), np.diff(self.doc_offsets))
        return doc_idx, self.doc_terms.astype(np.int64), self.doc_tfs.astype(np.float64)


def zipf_probs(n: int, alpha: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return p / p.sum()


def ragged_arange(counts: np.ndarray) -> np.ndarray:
    """``concat(arange(c) for c in counts)``."""
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(int(counts.sum()), dtype=np.int64) - starts


def _distinct_draws(rng, want: np.ndarray, p: np.ndarray, argsort) -> np.ndarray:
    """For each row, the first ``want[i]`` distinct values of an iid stream
    drawn with probabilities ``p``: successive sampling without
    replacement, as ``rng.choice(..., replace=False, p=p)`` draws. Rows whose
    stream runs short are drawn one by one."""
    n, extra = want.size, 2 * want + 8
    rows = np.repeat(np.arange(n, dtype=np.int64), extra)
    vals = rng.choice(p.size, size=rows.size, p=p).astype(np.int64)
    order = argsort(rows * p.size + vals)  # stable: the earliest draw first
    key = (rows * p.size + vals)[order]
    first = np.ones(key.size, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    keep_pos = np.sort(order[first])  # first occurrences, back in stream order
    rank = ragged_arange(np.bincount(rows[keep_pos], minlength=n))
    sel = keep_pos[rank < want[rows[keep_pos]]]
    got = np.bincount(rows[sel], minlength=n)
    out_rows, out_vals = rows[sel], vals[sel]
    short = np.flatnonzero(got < want)
    if short.size:  # a few rows a shard
        keep = ~np.isin(out_rows, short)
        parts_r, parts_v = [out_rows[keep]], [out_vals[keep]]
        for i in short:
            parts_r.append(np.full(want[i], i, dtype=np.int64))
            parts_v.append(rng.choice(p.size, size=want[i], replace=False, p=p).astype(np.int64))
        out_rows, out_vals = np.concatenate(parts_r), np.concatenate(parts_v)
        o = np.argsort(out_rows, kind="stable")
        out_rows, out_vals = out_rows[o], out_vals[o]
    return out_vals


def dedup_sum(keys: np.ndarray, values: np.ndarray, argsort) -> tuple[np.ndarray, np.ndarray]:
    """Unique keys ascending, with the values of equal keys summed in their
    original order (deterministic)."""
    order = argsort(keys)
    k, v = keys[order], values[order]
    start = np.ones(k.size, dtype=bool)
    start[1:] = k[1:] != k[:-1]
    idx = np.flatnonzero(start)
    return k[idx], np.add.reduceat(v, idx) if v.size else v


# Every seed deals out the same multiset of document sizes (concepts a
# document, surface terms a concept, stopwords), drawn once from this
# stream, in an order of its own: the longest document, which sets the
# width of the index's doc-major store and so most of its bytes, is then
# the same length whatever the seed.
SIZES_SEED = 20211021


def generate_corpus(cfg: CorpusConfig, argsort: Callable = np_argsort) -> Corpus:
    rng = np.random.default_rng(cfg.seed)
    sizes = np.random.default_rng([SIZES_SEED, cfg.n_docs])
    concept_p = zipf_probs(cfg.n_concepts, cfg.concept_zipf)
    term_p = zipf_probs(cfg.terms_per_concept, cfg.term_zipf)
    n, V = cfg.n_docs, cfg.n_surface_terms

    # ---------------- documents (drawn in the sizes' order, then dealt) ----------------
    n_con = np.minimum(np.maximum(sizes.poisson(cfg.concepts_per_doc, n), 1), cfg.n_concepts)
    strength = 0.6 ** ragged_arange(n_con).astype(np.float64)  # the first concept is central
    k = np.maximum(sizes.poisson(cfg.terms_per_doc_concept * strength), 1)
    n_stop = np.maximum(sizes.poisson(cfg.stopwords_per_doc, n), 0)
    deal = rng.permutation(n)  # the i-th size draw becomes document deal[i]
    concepts = _distinct_draws(rng, n_con, concept_p, argsort)
    con_doc = np.repeat(deal, n_con)
    rep_doc, rep_con, rep_str = (np.repeat(a, k) for a in (con_doc, concepts, strength))
    forms = rng.choice(cfg.terms_per_concept, size=rep_doc.size, p=term_p)
    c_terms = cfg.n_stopwords + rep_con * cfg.terms_per_concept + forms
    s_doc = np.repeat(deal, n_stop)
    s_terms = rng.integers(0, cfg.n_stopwords, s_doc.size)
    docs = np.concatenate([rep_doc, s_doc])
    terms = np.concatenate([c_terms, s_terms])
    str_all = np.concatenate([rep_str, np.ones(s_doc.size)])
    tfs = 1 + np.floor(rng.exponential(0.9 + 2.0 * str_all)).astype(np.int64)
    tfs = tfs.clip(1, cfg.max_tf)
    key, tf = dedup_sum(docs * V + terms, tfs, argsort)  # merge duplicate surface terms
    lengths = np.bincount(key // V, minlength=n)
    doc_offsets = np.zeros(n + 1, dtype=np.int64)
    doc_offsets[1:] = np.cumsum(lengths)
    by_doc = np.argsort(con_doc, kind="stable")  # each document's concepts, in drawing order
    concepts, strength = concepts[by_doc], strength[by_doc]
    concept_offsets = np.zeros(n + 1, dtype=np.int64)
    concept_offsets[1:] = np.cumsum(np.bincount(con_doc, minlength=n))
    corpus_docs = dict(
        doc_offsets=doc_offsets,
        doc_terms=(key % V).astype(np.int32),
        doc_tfs=tf.clip(1, cfg.max_tf * 4).astype(np.int32),
        concept_offsets=concept_offsets,
        concepts=concepts.astype(np.int32),
        strengths=strength.astype(np.float32),
    )

    # ---------------- queries (few: the port's loop) ----------------
    query_terms, query_concepts = [], []
    qrels = np.zeros(cfg.n_queries, dtype=np.int32)
    for qi in range(cfg.n_queries):
        d = int(rng.integers(0, n))
        qrels[qi] = d
        lo, hi = concept_offsets[d], concept_offsets[d + 1]
        dc, ds = corpus_docs["concepts"][lo:hi], corpus_docs["strengths"][lo:hi]
        m = min(max(int(rng.poisson(cfg.concepts_per_query)), 1), dc.size)
        p = ds.astype(np.float64) ** 2
        cs = rng.choice(dc, size=m, replace=False, p=p / p.sum())
        query_concepts.append(cs.astype(np.int32))
        kq = np.maximum(rng.poisson(cfg.terms_per_query_concept, m), 1)
        reps = np.repeat(cs.astype(np.int64), kq)
        f = rng.choice(cfg.terms_per_concept, size=reps.size, p=term_p)
        qt = cfg.n_stopwords + reps * cfg.terms_per_concept + f
        stops = rng.integers(0, cfg.n_stopwords, max(int(rng.poisson(cfg.stopwords_per_query)), 0))
        query_terms.append(np.unique(np.concatenate([qt, stops])).astype(np.int32))

    return Corpus(config=cfg, query_terms=query_terms, query_concepts=query_concepts,
                  qrels=qrels, **corpus_docs)


def mismatch_rate(corpus: Corpus) -> float:
    """Share of queries whose content terms share no surface term with their
    relevant document."""
    cfg = corpus.config
    miss = 0
    for qi in range(corpus.n_queries):
        dt, _ = corpus.doc(int(corpus.qrels[qi]))
        q = corpus.query_terms[qi]
        content = q[q >= cfg.n_stopwords]
        if content.size and not np.intersect1d(content, dt).size:
            miss += 1
    return miss / max(corpus.n_queries, 1)
