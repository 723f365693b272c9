"""The retrieval-model treatments of the corpus, for the benchmark's set-up.

A frozen copy of the port's ``models/treatments.py`` and ``models/bm25.py``:
each treatment turns the base corpus into COO document postings with
model-assigned weights, plus weighted queries. BM25 keeps the surface
terms and their BM25 weights with unit query weights; SPLADEv2 expands
documents and queries, maps them onto a subword vocabulary and gives them
flat ("wacky") learned weights. The arithmetic is the port's; the
deduplications sort through the caller's ``argsort`` and sum with
``np.add.reduceat`` instead of ``np.unique`` and ``np.add.at``, which cost
tens of seconds at a shard's size.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from portbench.data.synthetic import Corpus, dedup_sum, np_argsort


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    doc_expansion_forms: int
    query_expansion_forms: int
    learned_weights: bool
    query_weights: bool
    subword_frac: float
    subwords_per_term: int
    stopword_doc_weight: float
    stopword_query_terms: int
    weight_flatness: float
    weight_scale: float


PROFILES = {
    p.name: p
    for p in (
        ModelProfile("bm25", 0, 0, False, False, 0.0, 1, 0.0, 0, 0.0, 1.0),
        ModelProfile("bm25-t5", 4, 0, False, False, 0.0, 1, 0.0, 0, 0.0, 1.0),
        ModelProfile("deepimpact", 6, 0, True, False, 0.0, 1, 0.18, 0, 0.55, 24.0),
        ModelProfile("unicoil-t5", 6, 0, True, True, 1.0, 1, 0.22, 0, 0.62, 30.0),
        ModelProfile("unicoil-tilde", 11, 0, True, True, 1.0, 1, 0.22, 0, 0.62, 30.0),
        ModelProfile("spladev2", 16, 5, True, True, 1.0, 2, 0.35, 4, 0.78, 36.0),
    )
}
MODEL_NAMES = tuple(PROFILES)


@dataclasses.dataclass(frozen=True)
class EncodedCollection:
    name: str
    doc_idx: np.ndarray  # i64[nnz]
    term_idx: np.ndarray  # i64[nnz]
    weights: np.ndarray  # f64[nnz]
    query_terms: list  # list of i32 arrays
    query_weights: list  # list of f32 arrays
    n_terms: int

    @property
    def n_postings(self) -> int:
        return int(self.doc_idx.size)


def bm25_weights(doc_idx, term_idx, tf, n_docs, n_terms, k1=0.82, b=0.68) -> np.ndarray:
    """Per-posting BM25 weight (the paper's k1 and b)."""
    dl = np.bincount(doc_idx, weights=tf, minlength=n_docs).astype(np.float64)
    avdl = dl.mean() if n_docs else 1.0
    df = np.bincount(term_idx, minlength=n_terms).astype(np.float64)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    denom = tf + k1 * (1.0 - b + b * (dl[doc_idx] / max(avdl, 1e-9)))
    return (idf[term_idx] * tf * (k1 + 1.0) / denom).astype(np.float64)


class _StrengthLookup:
    """Per-posting concept centrality over sorted (doc, concept) keys."""

    def __init__(self, corpus: Corpus, searchsorted):
        cfg = corpus.config
        docs = np.repeat(np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.concept_offsets))
        keys = docs * cfg.n_concepts + corpus.concepts.astype(np.int64)
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._strs = corpus.strengths.astype(np.float64)[order]
        self._cfg = cfg
        self._searchsorted = searchsorted

    def __call__(self, doc_idx: np.ndarray, term_idx: np.ndarray) -> np.ndarray:
        cfg = self._cfg
        con = np.where(term_idx >= cfg.n_stopwords,
                       (term_idx - cfg.n_stopwords) // cfg.terms_per_concept, -1)
        keys = doc_idx.astype(np.int64) * cfg.n_concepts + con
        pos = self._searchsorted(self._keys, keys).clip(0, self._keys.size - 1)
        hit = (self._keys[pos] == keys) & (con >= 0)
        return np.where(hit, self._strs[pos], 0.1)


def _expand_docs(corpus: Corpus, forms: int):
    """Every (doc, concept) gains its concept's ``forms`` most query-popular
    surface forms with tf 1."""
    cfg = corpus.config
    docs = np.repeat(np.arange(corpus.n_docs, dtype=np.int64), np.diff(corpus.concept_offsets))
    cons = corpus.concepts.astype(np.int64)
    doc_rep = np.repeat(docs, forms)
    terms = cfg.n_stopwords + np.repeat(cons, forms) * cfg.terms_per_concept + np.tile(
        np.arange(forms, dtype=np.int64), cons.size)
    return doc_rep, terms, np.ones(terms.size, dtype=np.float64)


def _learned_weights(term_idx, tf, strength, n_stopwords, profile, rng) -> np.ndarray:
    tf = np.asarray(tf, dtype=np.float64)
    signal = (0.3 + 0.7 * strength) * (0.75 + 0.25 * np.log1p(tf) / np.log1p(8.0))
    noise = rng.lognormal(0.0, 0.2, term_idx.size)
    flat = profile.weight_flatness
    w = ((1.0 - flat) * signal + flat * (0.55 + 0.2 * rng.random(term_idx.size))) * noise
    stop = term_idx < n_stopwords
    w = np.where(stop, profile.stopword_doc_weight * (0.5 + rng.random(term_idx.size)), w)
    return np.maximum(w, 1e-3) * profile.weight_scale


def _subword_map(terms, vocab: int, copies: int, n_stopwords: int) -> np.ndarray:
    terms = np.asarray(terms, dtype=np.int64)
    outs = []
    for c in range(copies):
        h = (terms * 2654435761 + 97 + 1013904223 * c) % (vocab - n_stopwords)
        outs.append(np.where(terms < n_stopwords, terms, n_stopwords + h))
    return np.concatenate(outs)


def _dedup(doc_idx, term_idx, values, n_terms, argsort):
    key, v = dedup_sum(doc_idx.astype(np.int64) * n_terms + term_idx, values, argsort)
    return key // n_terms, key % n_terms, v


def apply_treatment(corpus: Corpus, model: str, seed: int = 0, argsort: Callable = np_argsort,
                    searchsorted: Callable = np.searchsorted) -> EncodedCollection:
    if model not in PROFILES:
        raise ValueError(f"unknown treatment {model!r}; choose from {MODEL_NAMES}")
    profile = PROFILES[model]
    cfg = corpus.config
    rng = np.random.default_rng(seed * 1009 + MODEL_NAMES.index(model))
    lookup = _StrengthLookup(corpus, searchsorted)

    doc_idx, term_idx, tf = corpus.coo()
    if profile.doc_expansion_forms > 0:
        ed, et, etf = _expand_docs(corpus, profile.doc_expansion_forms)
        doc_idx, term_idx, tf = _dedup(np.concatenate([doc_idx, ed]), np.concatenate([term_idx, et]),
                                       np.concatenate([tf, etf]), cfg.n_surface_terms, argsort)
    weights = None
    if profile.learned_weights:
        weights = _learned_weights(term_idx, tf, lookup(doc_idx, term_idx), cfg.n_stopwords,
                                   profile, rng)
    n_terms = cfg.n_surface_terms
    if profile.subword_frac:
        n_terms = max(2048, int(profile.subword_frac * cfg.n_surface_terms))
        copies = profile.subwords_per_term
        mapped = _subword_map(term_idx, n_terms, copies, cfg.n_stopwords)
        doc_idx, tf = np.tile(doc_idx, copies), np.tile(tf, copies)
        if weights is not None:
            doc_idx, term_idx, weights = _dedup(doc_idx, mapped, np.tile(weights / copies, copies),
                                                n_terms, argsort)
        else:
            doc_idx, term_idx, tf = _dedup(doc_idx, mapped, tf, n_terms, argsort)
    if weights is None:
        weights = bm25_weights(doc_idx, term_idx, tf, corpus.n_docs, n_terms)

    q_terms_out, q_weights_out = [], []
    for qi in range(corpus.n_queries):
        terms = corpus.query_terms[qi].astype(np.int64)
        d_focus = int(corpus.qrels[qi])
        cs = corpus.query_concepts[qi].astype(np.int64)
        kind = np.where(terms < cfg.n_stopwords, 2, 0)  # 0 content, 1 expansion, 2 stopword
        if profile.query_expansion_forms > 0:
            f = profile.query_expansion_forms
            exp = cfg.n_stopwords + np.repeat(cs, f) * cfg.terms_per_concept + np.tile(
                np.arange(f, dtype=np.int64), cs.size)
            terms = np.concatenate([terms, exp])
            kind = np.concatenate([kind, np.ones(exp.size, dtype=np.int64)])
        if profile.stopword_query_terms > 0:
            stops = rng.integers(0, cfg.n_stopwords, profile.stopword_query_terms)
            terms = np.concatenate([terms, stops])
            kind = np.concatenate([kind, np.full(stops.size, 2, dtype=np.int64)])
        if profile.query_weights:
            strength = lookup(np.full(terms.size, d_focus, dtype=np.int64), terms)
            base = 0.25 + 0.75 * strength
            base = np.where(kind == 1, 0.6 * base, base)
            base = np.where(kind == 2, 0.12, base)
            qw = base * (0.85 + 0.3 * rng.random(terms.size)) * profile.weight_scale * 0.6
        else:
            qw = np.ones(terms.size, dtype=np.float64)
        if profile.subword_frac:
            terms = _subword_map(terms, n_terms, 1, cfg.n_stopwords)
        ut = np.unique(terms)  # max-pool duplicate terms
        w = np.zeros(ut.size, dtype=np.float64)
        np.maximum.at(w, np.searchsorted(ut, terms), qw)
        q_terms_out.append(ut.astype(np.int32))
        q_weights_out.append(w.astype(np.float32))

    return EncodedCollection(model, doc_idx.astype(np.int64), term_idx.astype(np.int64),
                             np.asarray(weights, dtype=np.float64), q_terms_out, q_weights_out,
                             int(n_terms))
