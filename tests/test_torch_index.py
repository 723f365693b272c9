"""The port's corpus, treatments and impact index against the JAX reference.

The host-side data path is copied, so equality here is exact: the same seed
gives array-equal corpora and COO postings, and the port's build gives
every one of the 17 index fields array-equal to the reference's.
"""
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core.impact_index import META_FIELDS as REF_META_FIELDS
from repro_torch.core import (
    ARRAY_FIELDS,
    META_FIELDS,
    build_impact_index,
    extract_doc_coo,
    index_from_numpy,
    pad_queries,
    query_vector,
)
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.models.treatments import apply_treatment

pytestmark = pytest.mark.torch_port

TREATMENTS = ("bm25", "spladev2")


@pytest.fixture(scope="module")
def port_corpus(tiny_corpus):
    return generate_corpus(CorpusConfig(**{
        f: getattr(tiny_corpus.config, f) for f in tiny_corpus.config.__dataclass_fields__
    }))


def _ref_arrays(index):
    return {f: np.asarray(getattr(index, f)) for f in ARRAY_FIELDS}


def _assert_index_equal(ref, port):
    for f in ARRAY_FIELDS:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).cpu().numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in META_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f


def test_field_lists_match_reference():
    assert META_FIELDS == REF_META_FIELDS
    assert len(ARRAY_FIELDS) == 17


def test_corpus_array_equal(tiny_corpus, port_corpus):
    for f in ("doc_offsets", "doc_terms", "doc_tfs", "qrels"):
        np.testing.assert_array_equal(getattr(port_corpus, f), getattr(tiny_corpus, f), err_msg=f)
    for f in ("doc_concepts", "doc_concept_strengths", "query_terms", "query_concepts"):
        got, want = getattr(port_corpus, f), getattr(tiny_corpus, f)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("model", TREATMENTS)
def test_treatment_coo_array_equal(model, tiny_corpus, port_corpus, bm25_collection, splade_collection):
    ref = {"bm25": bm25_collection, "spladev2": splade_collection}[model]
    enc = apply_treatment(port_corpus, model)
    for f in ("doc_idx", "term_idx", "weights"):
        np.testing.assert_array_equal(getattr(enc, f), getattr(ref, f), err_msg=f)
    assert enc.n_terms == ref.n_terms
    for a, b in zip(enc.query_terms, ref.query_terms):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(enc.query_weights, ref.query_weights):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", TREATMENTS)
def test_index_fields_array_equal(model, tiny_corpus, bm25_collection, splade_collection):
    enc = {"bm25": bm25_collection, "spladev2": splade_collection}[model]
    args = (enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    ref = ref_build(*args)
    port = build_impact_index(*args, device="cpu")
    _assert_index_equal(ref, port)
    assert port.n_postings == ref.n_postings and port.n_segments == ref.n_segments
    assert port.nbytes() == ref.nbytes()
    assert port.posting_store_nbytes() == ref.posting_store_nbytes()


def test_index_pinned_grid_and_truncation(tiny_corpus, splade_collection):
    """quant_max_weight and a doc-major width below the longest doc."""
    enc = splade_collection
    args = (enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    kw = dict(quant_max_weight=float(enc.weights.max()) * 1.5, max_doc_terms=40, block_size=64)
    _assert_index_equal(ref_build(*args, **kw), build_impact_index(*args, device="cpu", **kw))


@pytest.mark.parametrize("n_docs", [0, 7, 300])
def test_index_empty_coo(n_docs):
    empty = np.zeros(0, np.int64)
    args = (empty, empty, np.zeros(0), n_docs, 50)
    _assert_index_equal(ref_build(*args), build_impact_index(*args, device="cpu"))


def test_index_from_numpy_round_trips_reference(tiny_corpus, bm25_collection):
    enc = bm25_collection
    ref = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    meta = {f: getattr(ref, f) for f in META_FIELDS}
    port = index_from_numpy(_ref_arrays(ref), meta, device="cpu")
    _assert_index_equal(ref, port)
    moved = port.to("cpu")
    _assert_index_equal(ref, moved)


def test_index_from_numpy_rejects_missing_fields():
    with pytest.raises(ValueError, match="missing"):
        index_from_numpy({"doc_ids": np.zeros(4, np.int32)}, {}, device="cpu")


def test_extract_doc_coo_and_query_helpers(tiny_corpus, bm25_collection, bm25_index, bm25_queries):
    from repro.core import extract_doc_coo as ref_extract
    from repro.core import query_vector as ref_query_vector

    enc = bm25_collection
    port = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs,
                              enc.n_terms, device="cpu")
    live = np.random.default_rng(0).random(tiny_corpus.n_docs) < 0.7
    for lv in (None, live):
        for got, want in zip(extract_doc_coo(port, lv), ref_extract(bm25_index, lv)):
            np.testing.assert_array_equal(got, want)
    max_q = max(len(t) for t in enc.query_terms)
    qt, qw = pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
    np.testing.assert_array_equal(qt, bm25_queries[0])
    np.testing.assert_array_equal(qw, bm25_queries[1])
    # a duplicated term and a zero-weight term
    t = np.array([qt[0, 0], qt[0, 0], qt[0, 1]], np.int32)
    w = np.array([0.5, 0.25, 0.0], np.float32)
    got = query_vector(port, torch.as_tensor(t), torch.as_tensor(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref_query_vector(bm25_index, t, w)))
