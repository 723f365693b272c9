"""The byte counts of ``roofline.py`` and the work counts they are fed, on a
hand-built index whose every count is worked out below."""
import numpy as np
import pytest
import torch

from portbench.reference.retrieval import ReferenceIndex, quantize_uniform
from portbench.roofline import (HBM_BYTES_PER_S, daat_query_bytes, roofline_pct,
                                saat_query_bytes)

torch.set_num_threads(1)

# (doc, term, weight); 6 docs in blocks of 2, 3 terms, 2-bit impacts (3 levels,
# scale 4/3): weight 4 -> impact 3, 3 -> 3 (ceil 2.25), 2 -> 2 (ceil 1.5), 1 -> 1.
POSTINGS = [
    (0, 0, 4.0), (1, 0, 2.0), (4, 0, 4.0),
    (1, 1, 1.0), (2, 1, 3.0), (3, 1, 3.0), (5, 1, 1.0),
    (0, 2, 2.0),
]


@pytest.fixture(scope="module")
def ref():
    d, t, w = (np.asarray(c) for c in zip(*POSTINGS))
    return ReferenceIndex(d, t, w, n_docs=6, n_terms=3, bits=2, block_size=2)


def test_quantization_by_hand():
    q, deq, scale = quantize_uniform(np.array([4.0, 3.0, 2.0, 1.0]), bits=2)
    assert q.tolist() == [3, 3, 2, 1]
    assert scale == pytest.approx(4 / 3)
    np.testing.assert_allclose(deq, [4.0, 4.0, 8 / 3, 4 / 3], rtol=1e-6)


def test_saat_budget_by_hand(ref):
    # query terms 0 and 1, unit weights: segments (t0, impact 3) 4.0 x2 docs,
    # (t1, 3) 4.0 x2, (t0, 2) 2.67 x1, (t1, 1) 1.33 x2; cum 2, 4, 5, 7
    terms, weights = [0, 1], [1.0, 1.0]
    assert ref.budget_counts(terms, weights, 3) == (3, 2, 2)
    assert ref.budget_counts(terms, weights, 5) == (5, 3, 2)
    assert ref.budget_counts(terms, weights, 100) == (7, 4, 2)
    a = ref.search(terms, weights, k=2, rho=3)
    assert (a.processed, a.segments) == (3, 2)
    # docs 0 and 4 (segment t0/3) and doc 2 (first posting of t1/3) score 4
    np.testing.assert_allclose(a.acc.numpy(), [4, 0, 4, 0, 4, 0], rtol=1e-6)
    assert a.ids.tolist() == [0, 2]  # ties to the lowest id
    full = ref.search(terms, weights, k=6)
    np.testing.assert_allclose(full.acc.numpy(), [4, 4, 4, 4, 4, 4 / 3], rtol=1e-6)
    # 4 B a doc id (3), 4 B a segment impact (2), 8 B a live slot (2), 8 B a pair (k 2)
    assert saat_query_bytes(3, 2, 2, 2) == 52


def test_daat_block_work_by_hand(ref):
    # block maxima: t0 {b0 4, b2 4}, t1 {b0 1.33, b1 4, b2 1.33}, t2 {b0 2.67};
    # bounds b0 5.33, b1 4, b2 5.33, so the order is b0, b2, b1; doc slots
    # b0 4, b1 2, b2 2; query-term slots b0 3, b1 2, b2 2
    terms, weights = [0, 1], [1.0, 1.0]
    assert ref.block_work(terms, weights, 1) == (5, 4, 3)
    assert ref.block_work(terms, weights, 2) == (5, 6, 5)
    assert ref.block_work(terms, weights, 3) == (5, 8, 7)
    assert daat_query_bytes(5, 6, 5, 2, 2) == 8 * 5 + 4 * 6 + 4 * 5 + 8 * 2 + 8 * 2


def test_counted_work_never_exceeds_the_inputs(ref):
    """However many blocks a run reports scored, the count reads no slot
    the index does not hold, and no posting the query's terms do not have;
    a budget admits no more than the query's postings."""
    terms, weights = [0, 1, 2], [1.0, 2.0, 0.5]
    total = ref.budget_counts(terms, weights, 10**9)[0]
    assert total == len(POSTINGS)
    for scored in range(0, 6):
        bm, slots, matched = ref.block_work(terms, weights, scored)
        assert bm == int(ref.term_bm_count[:3].sum())
        assert slots <= len(POSTINGS) and matched <= total
    for rho in (1, 4, 8, 10**6):
        processed, segments, live = ref.budget_counts(terms, weights, rho)
        assert processed == min(rho, total) and segments <= int(ref.term_seg_count.sum())


def test_roofline_share():
    assert roofline_pct(HBM_BYTES_PER_S * 0.5, 1.0) == pytest.approx(50.0)
    assert roofline_pct(1.0, 0.0) is None
