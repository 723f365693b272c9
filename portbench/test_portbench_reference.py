"""The benchmark's plain reference against the port's CPU path at a small
size: SAAT under a binding budget and exact, DAAT exact at k = 10 and
1000, both treatments. The comparison is the one a run makes
(``correctness.row_numbers``); the control, the reference in bfloat16, fails it."""
import numpy as np
import pytest
import torch

from portbench import correctness
from portbench.data import make_deployment
from portbench.harness import load_cell
from portbench.reference.retrieval import ReferenceIndex
from repro_torch.core.daat import daat_search_batched, max_blocks_per_term
from repro_torch.core.impact_index import build_impact_index
from repro_torch.core.saat import max_segments_per_term, saat_search

torch.set_num_threads(1)
CPU = torch.device("cpu")
LIMIT = load_cell("spladev2-saat-open").traffic["limits"]["score_gap"]


@pytest.fixture(scope="module", params=["msmarco-v1-spladev2-shard32", "msmarco-v1-bm25-shard32"])
def setup(request):
    cfg = dict(load_cell("spladev2-saat-open").config if "spladev2" in request.param
               else load_cell("bm25-daat-batch").config)
    cfg.update(n_docs=1500, n_queries=48)
    dep = make_deployment(cfg, 2**31 + 5, CPU)
    enc = dep.enc
    index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, dep.n_docs, enc.n_terms,
                               device=CPU)
    ref = ReferenceIndex(enc.doc_idx, enc.term_idx, enc.weights, dep.n_docs, enc.n_terms)
    qt, qw = dep.padded_pool()
    return dep, index, ref, qt, qw


def _rows(res, processed=None):
    ids, scores = res.doc_ids.numpy(), res.scores.numpy()
    pp = None if processed is None else processed.numpy()
    return [correctness.Served(i, ids[i], scores[i], None if pp is None else int(pp[i]))
            for i in range(ids.shape[0])]


def test_reference_index_is_the_ports(setup):
    dep, index, ref, _, _ = setup
    assert ref.n_postings == int(index.term_post_count.sum())
    assert ref.scale == pytest.approx(index.scale, rel=1e-15)
    assert int(ref.seg_len.numel()) == index.n_segments


@pytest.mark.parametrize("rho", ["binding", "exact"])
def test_saat_against_the_port(setup, rho):
    dep, index, ref, qt, qw = setup
    r = 150 if rho == "binding" else index.n_postings
    res = saat_search(index, qt, qw, k=10, rho=r, max_segs_per_term=max_segments_per_term(index),
                      scatter_impl="sort")
    served = _rows(res, res.postings_processed)
    if rho == "binding":
        assert (res.total_postings > r).any()  # the budget binds somewhere
    nums = correctness.compare(served, ref, dep.enc.query_terms, dep.enc.query_weights, k=10, rho=r)
    assert nums["bad_answers"] == 0 and nums["postings_off"] == 0
    assert nums["score_gap"] <= LIMIT / 10


@pytest.mark.parametrize("k", [10, 1000])
def test_daat_exact_against_the_port(setup, k):
    dep, index, ref, qt, qw = setup
    res = daat_search_batched(index, qt[:16], qw[:16], k=k, est_blocks=8, block_budget=2,
                              max_bm_per_term=max_blocks_per_term(index), exact=True)
    assert bool(res.rank_safe.all())
    nums = correctness.compare(_rows(res), ref, dep.enc.query_terms, dep.enc.query_weights, k=k,
                               rho=None)
    assert nums["bad_answers"] == 0 and nums["score_gap"] <= LIMIT / 10


def test_the_control_fails(setup):
    """The reference one precision below (bfloat16) in the system's place."""
    dep, _, ref, _, _ = setup
    terms, weights = dep.enc.query_terms, dep.enc.query_weights
    served = []
    for q in range(24):
        a = ref.search(terms[q], weights[q], 10, 1500, precision=torch.bfloat16)
        served.append(correctness.Served(q, a.ids, a.scores, a.processed))
    nums = correctness.compare(served, ref, terms, weights, k=10, rho=1500)
    assert nums["score_gap"] > 10 * LIMIT
    assert not correctness.judge(nums, load_cell("spladev2-saat-open").traffic["limits"])[0]


def test_a_wrong_answer_is_caught(setup):
    dep, index, ref, qt, qw = setup
    res = saat_search(index, qt[:8], qw[:8], k=10, rho=1500,
                      max_segs_per_term=max_segments_per_term(index), scatter_impl="sort")
    served = _rows(res, res.postings_processed)
    served[3].ids = served[3].ids.copy()
    served[3].ids[0] = (served[3].ids[0] + 1) % dep.n_docs  # another doc at rank 1
    nums = correctness.compare(served, ref, dep.enc.query_terms, dep.enc.query_weights, k=10,
                               rho=1500)
    assert nums["score_gap"] > LIMIT or nums["bad_answers"] > 0
    dup = _rows(res, res.postings_processed)
    dup[2].ids = np.concatenate([dup[2].ids[:1], dup[2].ids[:-1]])  # a doc twice
    assert correctness.compare(dup, ref, dep.enc.query_terms, dep.enc.query_weights, k=10,
                               rho=1500)["bad_answers"] == 1
