"""The six retrieval-model corpus treatments (paper §3.1, Tables 1 & 2).

Each treatment turns the base concept-latent corpus into an encoded
collection: COO document postings with model-assigned weights, plus weighted
queries. The treatments reproduce the *mechanisms* of the original models:

  BM25            raw surface terms, BM25 weights, unweighted queries.
  BM25-T5         doc2query-T5 document expansion (docs gain the most
                  query-likely surface forms of their concepts), then BM25.
  DeepImpact      T5 expansion + learned impact weights (flat, "wacky"),
                  unweighted queries, surface vocabulary.
  uniCOIL-T5      T5 expansion + learned weights on a BERT-like subword
                  vocabulary, learned *query* weights.
  uniCOIL-TILDE   TILDE expansion (broader, cheaper) + learned weights +
                  learned query weights.
  SPLADEv2        MLM-based expansion on both documents and queries, the
                  heaviest expansion + flattest weights; stopword mass on
                  queries included (the paper's "srsly, wtf?" comma effect).

Mechanism, not fiat: learned weights read the corpus' latent *concept
centrality* (the same signal queries target), so they rank better than
BM25's tf/idf proxy — but they are *flat* ("wacky"), which kills the
block-max skipping DAAT relies on. ``PROFILES`` carries the paper's Table 2
targets for side-by-side reporting.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import Corpus
from repro_torch.models.bm25 import bm25_weights

MODEL_NAMES = (
    "bm25",
    "bm25-t5",
    "deepimpact",
    "unicoil-t5",
    "unicoil-tilde",
    "spladev2",
)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Treatment knobs + the paper's Table 2 targets (for reporting)."""

    name: str
    doc_expansion_forms: int  # forms added per doc concept (doc2query/TILDE/MLM)
    query_expansion_forms: int  # forms added per query concept (SPLADE only)
    learned_weights: bool  # transformer-assigned (flat) vs BM25 weights
    query_weights: bool  # learned query-side weights
    subword_frac: float  # 0 = surface vocab; else subword vocab fraction
    subwords_per_term: int  # 1 = plain hash, 2 = split effect (SPLADE)
    stopword_doc_weight: float  # learned weight mass on stopwords in docs
    stopword_query_terms: int  # stopword tokens injected into queries
    weight_flatness: float  # in (0, 1]; higher = flatter ("wackier")
    weight_scale: float  # scales total mass (Table 2 "total terms")
    table2_targets: dict


PROFILES: dict[str, ModelProfile] = {
    "bm25": ModelProfile(
        name="bm25",
        doc_expansion_forms=0,
        query_expansion_forms=0,
        learned_weights=False,
        query_weights=False,
        subword_frac=0.0,
        subwords_per_term=1,
        stopword_doc_weight=0.0,
        stopword_query_terms=0,
        weight_flatness=0.0,
        weight_scale=1.0,
        table2_targets={"doc_unique": 30.1, "q_unique": 5.8, "doc_total": 39.8, "rr10": 0.187},
    ),
    "bm25-t5": ModelProfile(
        name="bm25-t5",
        doc_expansion_forms=4,
        query_expansion_forms=0,
        learned_weights=False,
        query_weights=False,
        subword_frac=0.0,
        subwords_per_term=1,
        stopword_doc_weight=0.0,
        stopword_query_terms=0,
        weight_flatness=0.0,
        weight_scale=1.0,
        table2_targets={"doc_unique": 51.1, "q_unique": 5.8, "doc_total": 224.7, "rr10": 0.277},
    ),
    "deepimpact": ModelProfile(
        name="deepimpact",
        doc_expansion_forms=6,
        query_expansion_forms=0,
        learned_weights=True,
        query_weights=False,
        subword_frac=0.0,
        subwords_per_term=1,
        stopword_doc_weight=0.18,
        stopword_query_terms=0,
        weight_flatness=0.55,
        weight_scale=24.0,
        table2_targets={"doc_unique": 71.1, "q_unique": 4.2, "doc_total": 4010.0, "rr10": 0.325},
    ),
    "unicoil-t5": ModelProfile(
        name="unicoil-t5",
        doc_expansion_forms=6,
        query_expansion_forms=0,
        learned_weights=True,
        query_weights=True,
        subword_frac=1.0,
        subwords_per_term=1,
        stopword_doc_weight=0.22,
        stopword_query_terms=0,
        weight_flatness=0.62,
        weight_scale=30.0,
        table2_targets={"doc_unique": 66.4, "q_unique": 6.6, "doc_total": 5032.3, "rr10": 0.352},
    ),
    "unicoil-tilde": ModelProfile(
        name="unicoil-tilde",
        doc_expansion_forms=11,
        query_expansion_forms=0,
        learned_weights=True,
        query_weights=True,
        subword_frac=1.0,
        subwords_per_term=1,
        stopword_doc_weight=0.22,
        stopword_query_terms=0,
        weight_flatness=0.62,
        weight_scale=30.0,
        table2_targets={"doc_unique": 107.6, "q_unique": 6.5, "doc_total": 8260.8, "rr10": 0.350},
    ),
    "spladev2": ModelProfile(
        name="spladev2",
        doc_expansion_forms=16,
        query_expansion_forms=5,
        learned_weights=True,
        query_weights=True,
        # frac=1.0: SPLADE's BERT vocab is the SAME size as uniCOIL's (paper
        # Table 2: 28131 vs 27678); a shrunken vocab over-collides subwords
        # and was measured to cost ~3 RR@10 points
        subword_frac=1.0,
        subwords_per_term=2,
        stopword_doc_weight=0.35,
        stopword_query_terms=4,
        weight_flatness=0.78,
        weight_scale=36.0,
        table2_targets={"doc_unique": 229.4, "q_unique": 25.0, "doc_total": 10794.8, "rr10": 0.369},
    ),
}


@dataclasses.dataclass(frozen=True)
class EncodedCollection:
    """A (model x corpus) encoding, ready for ``build_impact_index``."""

    name: str
    doc_idx: np.ndarray  # i64[nnz]
    term_idx: np.ndarray  # i64[nnz]
    weights: np.ndarray  # f64[nnz]
    query_terms: list  # list of i32 arrays
    query_weights: list  # list of f32 arrays
    n_terms: int
    profile: ModelProfile

    @property
    def n_postings(self) -> int:
        return int(self.doc_idx.size)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


class _StrengthLookup:
    """O(log n) per-posting concept-centrality lookup over (doc, concept)."""

    def __init__(self, corpus: Corpus):
        cfg = corpus.config
        docs = np.repeat(
            np.arange(corpus.n_docs, dtype=np.int64),
            [c.size for c in corpus.doc_concepts],
        )
        cons = np.concatenate(corpus.doc_concepts).astype(np.int64)
        strs = np.concatenate(corpus.doc_concept_strengths).astype(np.float64)
        keys = docs * cfg.n_concepts + cons
        order = np.argsort(keys)
        self._keys = keys[order]
        self._strs = strs[order]
        self._cfg = cfg

    def concept_of(self, term_idx: np.ndarray) -> np.ndarray:
        cfg = self._cfg
        return np.where(
            term_idx >= cfg.n_stopwords,
            (term_idx - cfg.n_stopwords) // cfg.terms_per_concept,
            -1,
        )

    def __call__(self, doc_idx: np.ndarray, term_idx: np.ndarray) -> np.ndarray:
        """Per-posting strength in [0, 1]; stopwords/unknown get 0.1."""
        cfg = self._cfg
        con = self.concept_of(term_idx)
        keys = doc_idx.astype(np.int64) * cfg.n_concepts + con
        pos = np.searchsorted(self._keys, keys).clip(0, self._keys.size - 1)
        hit = (self._keys[pos] == keys) & (con >= 0)
        return np.where(hit, self._strs[pos], 0.1)


def _expand_docs(corpus: Corpus, forms_per_concept: int):
    """doc2query/TILDE/MLM-style document expansion.

    For every (doc, concept) pair, append the concept's ``forms_per_concept``
    most *query-popular* surface forms (what a seq2seq trained on queries
    predicts) with tf=1. Returns extra COO (doc, term, tf) postings.
    """
    cfg = corpus.config
    docs = np.repeat(
        np.arange(corpus.n_docs, dtype=np.int64),
        [c.size for c in corpus.doc_concepts],
    )
    cons = np.concatenate(corpus.doc_concepts).astype(np.int64)
    doc_rep = np.repeat(docs, forms_per_concept)
    con_rep = np.repeat(cons, forms_per_concept)
    form = np.tile(np.arange(forms_per_concept, dtype=np.int64), cons.size)
    terms = cfg.n_stopwords + con_rep * cfg.terms_per_concept + form
    tfs = np.ones(terms.size, dtype=np.float64)
    return doc_rep, terms, tfs


def _learned_weights(
    term_idx: np.ndarray,
    tf: np.ndarray,
    strength: np.ndarray,
    n_stopwords: int,
    profile: ModelProfile,
    rng,
) -> np.ndarray:
    """Transformer-style "wacky" impact weights.

    signal      concept centrality (the relevance signal tf/idf only proxies)
    flat floor  learned weights cluster in a narrow band -> loose block-max
                bounds -> DAAT skipping collapses (paper §4.2)
    stopwords   non-trivial learned mass ("and": 225 in the paper's example)
    """
    tf = np.asarray(tf, dtype=np.float64)
    signal = (0.3 + 0.7 * strength) * (0.75 + 0.25 * np.log1p(tf) / np.log1p(8.0))
    noise = rng.lognormal(0.0, 0.2, term_idx.size)
    flat = profile.weight_flatness
    w = ((1.0 - flat) * signal + flat * (0.55 + 0.2 * rng.random(term_idx.size))) * noise
    stop = term_idx < n_stopwords
    w = np.where(stop, profile.stopword_doc_weight * (0.5 + rng.random(term_idx.size)), w)
    return np.maximum(w, 1e-3) * profile.weight_scale


def _subword_vocab_size(profile: ModelProfile, n_surface: int) -> int:
    return max(2048, int(profile.subword_frac * n_surface))


def _subword_map(terms: np.ndarray, vocab: int, copies: int, n_stopwords: int) -> np.ndarray:
    """Hash surface terms onto a BERT-like subword vocabulary.

    Many-to-one collisions reproduce the paper's subword conflation ("and" vs
    "##rogen"); ``copies=2`` splits a term into two subwords (SPLADE docs).
    Stopwords map to a reserved low range so their identity (and wacky query
    mass) is preserved. Output shape: [copies * len(terms)].
    """
    terms = np.asarray(terms, dtype=np.int64)
    outs = []
    for c in range(copies):
        h = (terms * 2654435761 + 97 + 1013904223 * c) % (vocab - n_stopwords)
        mapped = np.where(terms < n_stopwords, terms, n_stopwords + h)
        outs.append(mapped)
    return np.concatenate(outs)


def _dedup_coo(doc_idx, term_idx, weights, n_terms: int, mode: str = "sum"):
    key = doc_idx.astype(np.int64) * n_terms + term_idx
    uk, inv = np.unique(key, return_inverse=True)
    w = np.zeros(uk.size, dtype=np.float64)
    if mode == "sum":
        np.add.at(w, inv, weights)
    else:  # max-pool (SPLADE)
        np.maximum.at(w, inv, weights)
    return (uk // n_terms).astype(np.int64), (uk % n_terms).astype(np.int64), w


# --------------------------------------------------------------------------
# the treatment itself
# --------------------------------------------------------------------------


def apply_treatment(corpus: Corpus, model: str, seed: int = 0) -> EncodedCollection:
    """Encode the base corpus under one of the six retrieval models."""
    if model not in PROFILES:
        raise ValueError(f"unknown model {model!r}; choose from {MODEL_NAMES}")
    profile = PROFILES[model]
    cfg = corpus.config
    rng = np.random.default_rng(seed * 1009 + list(PROFILES).index(model))
    lookup = _StrengthLookup(corpus)

    doc_idx, term_idx, tf = corpus.coo()
    if profile.doc_expansion_forms > 0:
        ed, et, etf = _expand_docs(corpus, profile.doc_expansion_forms)
        doc_idx = np.concatenate([doc_idx, ed])
        term_idx = np.concatenate([term_idx, et])
        tf = np.concatenate([tf, etf])
        doc_idx, term_idx, tf = _dedup_coo(doc_idx, term_idx, tf, cfg.n_surface_terms, "sum")

    # learned weights are computed on the *surface* postings (where concept
    # identity is known), then optionally mapped to subwords
    if profile.learned_weights:
        strength = lookup(doc_idx, term_idx)
        weights = _learned_weights(term_idx, tf, strength, cfg.n_stopwords, profile, rng)
    else:
        weights = None  # BM25 computed after (optional) vocab mapping

    n_terms = cfg.n_surface_terms
    if profile.subword_frac:
        n_terms = _subword_vocab_size(profile, cfg.n_surface_terms)
        copies = profile.subwords_per_term
        mapped = _subword_map(term_idx, n_terms, copies, cfg.n_stopwords)
        doc_idx = np.tile(doc_idx, copies)
        tf = np.tile(tf, copies)
        if weights is not None:
            weights = np.tile(weights / copies, copies)
        term_idx = mapped
        if weights is not None:
            doc_idx, term_idx, weights = _dedup_coo(doc_idx, term_idx, weights, n_terms, "sum")
        else:
            doc_idx, term_idx, tf = _dedup_coo(doc_idx, term_idx, tf, n_terms, "sum")

    if weights is None:
        weights = bm25_weights(doc_idx, term_idx, tf, corpus.n_docs, n_terms)

    # ---------------- queries ----------------
    q_terms_out, q_weights_out = [], []
    for qi in range(corpus.n_queries):
        terms = corpus.query_terms[qi].astype(np.int64)
        d_focus = int(corpus.qrels[qi])
        cs = corpus.query_concepts[qi].astype(np.int64)
        kind = np.zeros(terms.size, dtype=np.int64)  # 0=content, 1=expansion, 2=stop
        kind[terms < cfg.n_stopwords] = 2
        if profile.query_expansion_forms > 0:  # SPLADE-style query expansion
            reps = np.repeat(cs, profile.query_expansion_forms)
            form = np.tile(np.arange(profile.query_expansion_forms, dtype=np.int64), cs.size)
            exp = cfg.n_stopwords + reps * cfg.terms_per_concept + form
            terms = np.concatenate([terms, exp])
            kind = np.concatenate([kind, np.ones(exp.size, dtype=np.int64)])
        if profile.stopword_query_terms > 0:
            stops = rng.integers(0, cfg.n_stopwords, profile.stopword_query_terms)
            terms = np.concatenate([terms, stops])
            kind = np.concatenate([kind, np.full(stops.size, 2, dtype=np.int64)])
        if profile.query_weights:
            # learned query weights track term informativeness for this query
            strength = lookup(np.full(terms.size, d_focus, dtype=np.int64), terms)
            base = 0.25 + 0.75 * strength
            base = np.where(kind == 1, 0.6 * base, base)  # expansion discount
            base = np.where(kind == 2, 0.12, base)  # stopword down-weight
            qw = base * (0.85 + 0.3 * rng.random(terms.size)) * profile.weight_scale * 0.6
        else:
            qw = np.ones(terms.size, dtype=np.float64)
        if profile.subword_frac:
            terms = _subword_map(terms, n_terms, 1, cfg.n_stopwords)
        # dedup (max weight wins, SPLADE max-pool semantics)
        ut = np.unique(terms)
        w = np.zeros(ut.size, dtype=np.float64)
        pos = np.searchsorted(ut, terms)
        np.maximum.at(w, pos, qw)
        q_terms_out.append(ut.astype(np.int32))
        q_weights_out.append(w.astype(np.float32))

    return EncodedCollection(
        name=model,
        doc_idx=doc_idx,
        term_idx=term_idx,
        weights=weights,
        query_terms=q_terms_out,
        query_weights=q_weights_out,
        n_terms=int(n_terms),
        profile=profile,
    )


def encode_all(corpus: Corpus, seed: int = 0, models=MODEL_NAMES) -> dict[str, EncodedCollection]:
    return {m: apply_treatment(corpus, m, seed=seed) for m in models}
