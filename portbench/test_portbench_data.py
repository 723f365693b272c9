"""The benchmark's vectorized copy of the corpus and its treatments, held to
the port's generator at a small size: the same statistics, not the same
bytes (the copy draws the documents in whole-corpus calls)."""
import json

import numpy as np
import pytest
import torch

from portbench.data import device_sort_ops
from portbench.data.synthetic import CorpusConfig, generate_corpus, mismatch_rate, np_argsort
from portbench.data.treatments import apply_treatment
from portbench.harness import ROOT, load_benchmark
from repro_torch.data import synthetic as port_synthetic
from repro_torch.models import treatments as port_treatments

torch.set_num_threads(1)

N_DOCS, N_QUERIES = 3000, 2500


@pytest.fixture(scope="module")
def corpora():
    ours = [generate_corpus(CorpusConfig(n_docs=N_DOCS, n_queries=N_QUERIES, seed=s)) for s in (1, 2)]
    port = [port_synthetic.generate_corpus(
        port_synthetic.CorpusConfig(n_docs=N_DOCS, n_queries=N_QUERIES, seed=s)) for s in (1, 2)]
    return ours, port


def _doc_lengths(c):
    return np.diff(c.doc_offsets)


def test_doc_lengths_match_the_port(corpora):
    ours, port = corpora
    a = np.concatenate([_doc_lengths(c) for c in ours])
    b = np.concatenate([_doc_lengths(c) for c in port])
    assert a.mean() == pytest.approx(b.mean(), rel=0.03)
    assert a.std() == pytest.approx(b.std(), rel=0.08)
    for q in (10, 50, 90):
        assert abs(np.percentile(a, q) - np.percentile(b, q)) <= 2
    tf_a = np.concatenate([c.doc_tfs for c in ours])
    tf_b = np.concatenate([c.doc_tfs for c in port])
    assert tf_a.mean() == pytest.approx(tf_b.mean(), rel=0.03)


def test_mismatch_rate_matches_the_port(corpora):
    ours, port = corpora
    a = np.mean([mismatch_rate(c) for c in ours])
    b = np.mean([port_synthetic.mismatch_rate(c) for c in port])
    assert abs(a - b) <= 0.04


@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_treatment_postings_match_the_port(corpora, model):
    ours, port = corpora
    ea = [apply_treatment(c, model, seed=s) for c, s in zip(ours, (1, 2))]
    eb = [port_treatments.apply_treatment(c, model, seed=s) for c, s in zip(port, (1, 2))]
    assert ea[0].n_terms == eb[0].n_terms
    per_doc_a = np.mean([e.n_postings / N_DOCS for e in ea])
    per_doc_b = np.mean([e.n_postings / N_DOCS for e in eb])
    assert per_doc_a == pytest.approx(per_doc_b, rel=0.03)
    wa = np.concatenate([e.weights for e in ea])
    wb = np.concatenate([e.weights for e in eb])
    assert wa.mean() == pytest.approx(wb.mean(), rel=0.03)
    assert np.percentile(wa, 90) == pytest.approx(np.percentile(wb, 90), rel=0.05)
    qa = np.concatenate([[t.size for t in e.query_terms] for e in ea])
    qb = np.concatenate([[t.size for t in e.query_terms] for e in eb])
    assert qa.mean() == pytest.approx(qb.mean(), rel=0.05)


def test_the_treatment_is_the_ports_on_one_corpus(corpora):
    """On the same base corpus the copy's treatment gives the port's postings
    and weights exactly: only the document draw is vectorized."""
    ours, _ = corpora
    c = ours[0]
    docs = [port_synthetic.Corpus(
        config=port_synthetic.CorpusConfig(n_docs=N_DOCS, n_queries=N_QUERIES, seed=1),
        doc_offsets=c.doc_offsets, doc_terms=c.doc_terms, doc_tfs=c.doc_tfs,
        doc_concepts=[c.doc_concepts(i)[0] for i in range(c.n_docs)],
        doc_concept_strengths=[c.doc_concepts(i)[1] for i in range(c.n_docs)],
        query_terms=c.query_terms, query_concepts=c.query_concepts, qrels=c.qrels)]
    for model in ("bm25", "spladev2"):
        a = apply_treatment(c, model, seed=1)
        b = port_treatments.apply_treatment(docs[0], model, seed=1)
        np.testing.assert_array_equal(a.doc_idx, b.doc_idx)
        np.testing.assert_array_equal(a.term_idx, b.term_idx)
        np.testing.assert_allclose(a.weights, b.weights, rtol=1e-12)
        for x, y in zip(a.query_weights, b.query_weights):
            np.testing.assert_array_equal(x, y)


def test_same_seed_same_data_on_any_sort_device():
    cfg = CorpusConfig(n_docs=500, n_queries=40, seed=2**31 + 11)
    argsort, searchsorted = device_sort_ops(torch.device("cpu"))
    a = generate_corpus(cfg)
    b = generate_corpus(cfg, argsort=argsort)
    for f in ("doc_offsets", "doc_terms", "doc_tfs", "concepts", "qrels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    ea = apply_treatment(a, "spladev2", seed=cfg.seed)
    eb = apply_treatment(b, "spladev2", seed=cfg.seed, argsort=argsort, searchsorted=searchsorted)
    np.testing.assert_array_equal(ea.weights, eb.weights)
    c = generate_corpus(CorpusConfig(n_docs=500, n_queries=40, seed=2**31 + 12))
    assert not np.array_equal(a.doc_terms[:200], c.doc_terms[:200])


@pytest.mark.parametrize("entry", load_benchmark()["configs"], ids=lambda e: e["name"])
def test_configuration_meets_its_published_statistics(entry):
    """A configuration's corpus sizes give its treatment the term counts the
    source publishes (``published``), within 3%, at a small shard: they are
    counts a passage and a query, which do not grow with the shard."""
    cfg = json.loads((ROOT / entry["file"]).read_text())
    corpus = generate_corpus(CorpusConfig(n_docs=4000, n_queries=1500, seed=2**31 + 21,
                                          **cfg["corpus"]))
    enc = apply_treatment(corpus, cfg["treatment"], seed=2**31 + 21)
    pub = cfg["published"]
    got = {
        "doc_unique_terms": enc.n_postings / corpus.n_docs,
        "doc_total_terms": corpus.doc_tfs.sum() / corpus.n_docs,
        "query_unique_terms": np.mean([t.size for t in enc.query_terms]),
    }
    for key, value in got.items():
        if key in pub:
            assert value == pytest.approx(pub[key], rel=0.03), key
    c = cfg["corpus"]
    assert enc.n_terms == pub.get("vocabulary",
                                  c["n_stopwords"] + c["n_concepts"] * c["terms_per_concept"])


def test_distinct_draws_when_many_rows_run_short():
    """Rows whose stream of draws holds too few distinct values are drawn
    again one by one; each row still gets its count of distinct values."""
    from portbench.data.synthetic import _distinct_draws, zipf_probs

    rng = np.random.default_rng(2**31 + 7)
    want = np.array([12, 1, 14, 3, 13, 12, 2, 15] * 8)
    vals = _distinct_draws(rng, want, zipf_probs(40, 2.5), np_argsort)
    rows = np.repeat(np.arange(want.size), want)
    assert vals.size == want.sum()
    for r in range(want.size):
        assert np.unique(vals[rows == r]).size == want[r]
