"""Concept-latent synthetic corpus with built-in vocabulary mismatch.

The paper evaluates on MS MARCO passages with five pre-encoded model
treatments. We have no network access, so (DESIGN.md §7.3) we *generate* a
corpus whose retrieval difficulty has the same mechanism that makes learned
sparse models win on MS MARCO: **vocabulary mismatch**.

Generative story:
  * ``n_concepts`` latent concepts; concept popularity ~ Zipf.
  * each concept owns ``terms_per_concept`` surface terms (synonyms / related
    phrasings), with an internal Zipf distribution over which surface term a
    writer picks.
  * a shared stopword vocabulary is mixed into every document and query.
  * a document samples a few concepts, then surface terms *per concept*; a
    query is authored about a focus document's concepts but re-samples the
    surface terms independently — so query and relevant document frequently
    use *different* surface forms of the same concept. Plain BM25 cannot
    bridge that gap; expansion models (doc2query/TILDE/SPLADE treatments in
    ``repro.models``) bridge it by construction, which is precisely how they
    earn their Table-1 effectiveness edge here, mechanistically rather than
    by fiat.

Qrels are MS MARCO style: one relevant (focus) document per query, evaluated
with RR@10.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 20000
    n_queries: int = 200
    n_concepts: int = 2000
    terms_per_concept: int = 24
    n_stopwords: int = 64
    concepts_per_doc: float = 6.0  # Poisson mean (>=1 enforced)
    terms_per_doc_concept: float = 4.0  # surface terms drawn per (doc, concept)
    stopwords_per_doc: float = 6.0
    concepts_per_query: float = 2.0
    terms_per_query_concept: float = 1.3
    stopwords_per_query: float = 0.8
    concept_zipf: float = 1.1  # popularity skew across concepts
    term_zipf: float = 1.2  # skew across surface forms within a concept
    max_tf: int = 8
    seed: int = 0

    @property
    def n_surface_terms(self) -> int:
        return self.n_stopwords + self.n_concepts * self.terms_per_concept


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Base (pre-treatment) corpus: docs/queries over the surface vocabulary."""

    config: CorpusConfig
    # documents, CSR over a ragged (term, tf) representation
    doc_offsets: np.ndarray  # i64[n_docs + 1]
    doc_terms: np.ndarray  # i32[nnz] surface term ids
    doc_tfs: np.ndarray  # i32[nnz]
    doc_concepts: list  # list of i32 arrays (latent, used by expansion models)
    doc_concept_strengths: list  # list of f32 arrays: how central each concept is
    # queries (ragged)
    query_terms: list  # list of i32 arrays
    query_concepts: list  # list of i32 arrays (latent)
    qrels: np.ndarray  # i32[n_queries] focus (relevant) doc per query

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_queries(self) -> int:
        return len(self.query_terms)

    def doc(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.doc_offsets[i], self.doc_offsets[i + 1]
        return self.doc_terms[lo:hi], self.doc_tfs[lo:hi]

    def coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(doc_idx, term_idx, tf) postings."""
        doc_idx = np.repeat(
            np.arange(self.n_docs, dtype=np.int64), np.diff(self.doc_offsets)
        )
        return doc_idx, self.doc_terms.astype(np.int64), self.doc_tfs.astype(np.float64)


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    p = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return p / p.sum()


def _sample_counts(rng, mean: float, n: int, minimum: int = 0) -> np.ndarray:
    return np.maximum(rng.poisson(mean, n), minimum)


def generate_corpus(cfg: CorpusConfig) -> Corpus:
    """Generate the base corpus (host-side numpy; offline data prep)."""
    rng = np.random.default_rng(cfg.seed)
    concept_p = _zipf_probs(cfg.n_concepts, cfg.concept_zipf)
    term_p = _zipf_probs(cfg.terms_per_concept, cfg.term_zipf)

    def concept_term(concepts: np.ndarray, forms: np.ndarray) -> np.ndarray:
        return cfg.n_stopwords + concepts * cfg.terms_per_concept + forms

    # ---------------- documents ----------------
    n_con = _sample_counts(rng, cfg.concepts_per_doc, cfg.n_docs, minimum=1)
    doc_concepts: list[np.ndarray] = []
    doc_strengths: list[np.ndarray] = []
    all_terms: list[np.ndarray] = []
    all_tfs: list[np.ndarray] = []
    lengths = np.zeros(cfg.n_docs, dtype=np.int64)
    # vectorized-ish: loop over docs but with array ops inside (host data prep)
    for i in range(cfg.n_docs):
        cs = rng.choice(cfg.n_concepts, size=n_con[i], replace=False, p=concept_p)
        doc_concepts.append(cs.astype(np.int32))
        # concept centrality: a doc is "about" its first concepts (geometric
        # decay); central concepts get more surface terms and higher tfs, and
        # queries about this doc target its central concepts — the relevance
        # signal learned weights can exploit but BM25 only sees through tf.
        strength = 0.6 ** np.arange(n_con[i], dtype=np.float64)
        strength = strength / strength.max()
        doc_strengths.append(strength.astype(np.float32))
        k = np.maximum(rng.poisson(cfg.terms_per_doc_concept * strength), 1)
        reps = np.repeat(cs, k)
        forms = rng.choice(cfg.terms_per_concept, size=reps.size, p=term_p)
        terms = concept_term(reps, forms)
        rep_strength = np.repeat(strength, k)
        n_stop = max(int(rng.poisson(cfg.stopwords_per_doc)), 0)
        stops = rng.integers(0, cfg.n_stopwords, n_stop)
        terms = np.concatenate([terms, stops])
        # heavy-tailed tf (centrality-boosted): BM25's within-term weight
        # variance (and hence block-max skipping headroom) comes from here
        str_all = np.concatenate([rep_strength, np.full(n_stop, 1.0)])
        tfs = 1 + np.floor(rng.exponential(0.9 + 2.0 * str_all)).astype(np.int64)
        tfs = tfs.clip(1, cfg.max_tf)
        # merge duplicate surface terms
        ut, inv = np.unique(terms, return_inverse=True)
        tf = np.zeros(ut.size, dtype=np.int64)
        np.add.at(tf, inv, tfs)
        all_terms.append(ut.astype(np.int32))
        all_tfs.append(tf.clip(1, cfg.max_tf * 4).astype(np.int32))
        lengths[i] = ut.size
    doc_offsets = np.zeros(cfg.n_docs + 1, dtype=np.int64)
    doc_offsets[1:] = np.cumsum(lengths)
    doc_terms = np.concatenate(all_terms)
    doc_tfs = np.concatenate(all_tfs)

    # ---------------- queries ----------------
    query_terms: list[np.ndarray] = []
    query_concepts: list[np.ndarray] = []
    qrels = np.zeros(cfg.n_queries, dtype=np.int32)
    for qi in range(cfg.n_queries):
        d = int(rng.integers(0, cfg.n_docs))
        qrels[qi] = d
        m = min(max(int(rng.poisson(cfg.concepts_per_query)), 1), doc_concepts[d].size)
        # queries target the doc's central concepts
        p = doc_strengths[d].astype(np.float64) ** 2
        p = p / p.sum()
        cs = rng.choice(doc_concepts[d], size=m, replace=False, p=p)
        query_concepts.append(cs.astype(np.int32))
        k = _sample_counts(rng, cfg.terms_per_query_concept, m, minimum=1)
        reps = np.repeat(cs, k)
        # independent surface-form resampling => vocabulary mismatch
        forms = rng.choice(cfg.terms_per_concept, size=reps.size, p=term_p)
        terms = concept_term(reps, forms)
        n_stop = max(int(rng.poisson(cfg.stopwords_per_query)), 0)
        stops = rng.integers(0, cfg.n_stopwords, n_stop)
        terms = np.unique(np.concatenate([terms, stops]))
        query_terms.append(terms.astype(np.int32))

    return Corpus(
        config=cfg,
        doc_offsets=doc_offsets,
        doc_terms=doc_terms,
        doc_tfs=doc_tfs,
        doc_concepts=doc_concepts,
        doc_concept_strengths=doc_strengths,
        query_terms=query_terms,
        query_concepts=query_concepts,
        qrels=qrels,
    )


def mismatch_rate(corpus: Corpus) -> float:
    """Fraction of queries with no raw surface-term overlap with their
    relevant document — the quantity expansion models exist to fix."""
    cfg = corpus.config
    miss = 0
    for qi in range(corpus.n_queries):
        d = corpus.qrels[qi]
        dt, _ = corpus.doc(d)
        q = corpus.query_terms[qi]
        content = q[q >= cfg.n_stopwords]
        if content.size and not np.intersect1d(content, dt).size:
            miss += 1
    return miss / max(corpus.n_queries, 1)
