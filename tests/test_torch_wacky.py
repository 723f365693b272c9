"""The port's weight analysis (``core/wacky.py``, ``core/pareto.py``)
against the JAX reference's.

``full_report``, ``term_statistics``, ``blockmax_tightness``,
``skip_opportunity`` and ``accumulator_overflow`` run on the same index (the
conftest ``bm25`` index and a ``spladev2`` index of ``tiny_corpus``, each
also at blocks of 32 docs, where a query sees more than four blocks) and the
same queries in both packages. Integers and booleans must be equal; floats
agree to rtol 1e-6 (the exhaustive scores that give theta are sums taken in
another order). The port's ``skip_opportunity`` takes the batch's bounds
from one ``block_prune_csr`` call (its plain version here), which must equal
``block_upper_bounds`` bit for bit. ``pareto_frontier``, ``dominated_by``
and ``frontier_table`` run on random point sets (hypothesis) in both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import build_impact_index as ref_build
from repro.core import pad_queries as ref_pad_queries
from repro.core import pareto as ref_pareto
from repro.core import wacky as ref_wacky
from repro_torch.core import (
    ARRAY_FIELDS,
    META_FIELDS,
    block_upper_bounds,
    index_from_numpy,
    max_blocks_per_term,
    pareto,
    wacky,
)

pytestmark = pytest.mark.torch_port

RTOL = 1e-6


def _port_index(ref_index):
    arrays = {f: np.asarray(getattr(ref_index, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(ref_index, f) for f in META_FIELDS}
    return index_from_numpy(arrays, meta, device="cpu")


def _assert_same(got, want, path="report"):
    """Dicts and sequences alike; ints and bools equal, floats to RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (bool, np.bool_, str)):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)):
        assert isinstance(got, (int, np.integer)) and got == want, (path, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=path)


@pytest.fixture(scope="module")
def setups(tiny_corpus, bm25_collection, splade_collection, bm25_index, bm25_queries):
    """name -> (collection, reference index, port index, q_terms, q_weights)."""
    enc = splade_collection
    max_q = max(len(t) for t in enc.query_terms)
    sq = tuple(np.asarray(a) for a in ref_pad_queries(enc.query_terms, enc.query_weights, max_q,
                                                      enc.n_terms))
    bq = tuple(np.asarray(a) for a in bm25_queries)
    out = {"bm25": (bm25_collection, bm25_index, _port_index(bm25_index), *bq)}
    for name, coll, q in (("bm25_bs32", bm25_collection, bq), ("spladev2", enc, sq),
                          ("spladev2_bs32", enc, sq)):
        bs = 32 if name.endswith("bs32") else 128
        ref = ref_build(coll.doc_idx, coll.term_idx, coll.weights, tiny_corpus.n_docs,
                        coll.n_terms, block_size=bs)
        out[name] = (coll, ref, _port_index(ref), *q)
    return out


NAMES = ("bm25", "bm25_bs32", "spladev2", "spladev2_bs32")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("k", [1, 10])
def test_full_report_matches_the_reference(setups, name, k):
    coll, ref, port, qt, qw = setups[name]
    want = ref_wacky.full_report(name, ref, coll.weights, jnp.asarray(qt), jnp.asarray(qw), k=k)
    got = wacky.full_report(name, port, coll.weights, qt, qw, k=k)
    _assert_same(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_skip_opportunity_matches_the_reference(setups, name):
    _, ref, port, qt, qw = setups[name]
    mb = max_blocks_per_term(port)
    want = ref_wacky.skip_opportunity(ref, jnp.asarray(qt), jnp.asarray(qw), k=5,
                                      max_bm_per_term=mb)
    got = wacky.skip_opportunity(port, torch.as_tensor(qt), torch.as_tensor(qw), k=5,
                                 max_bm_per_term=mb)
    _assert_same(got, want)
    if name.endswith("bs32"):  # more than four blocks: some are skippable
        assert got["skippable_fraction_mean"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_batch_bounds_equal_block_upper_bounds_bit_for_bit(setups, name):
    _, _, port, qt, qw = setups[name]
    mb = max_blocks_per_term(port)
    qt, qw = torch.as_tensor(qt), torch.as_tensor(qw)
    got = wacky.batch_upper_bounds(port, qt, qw, mb)
    want = block_upper_bounds(port, qt, qw, mb)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_blockmax_tightness_and_accumulator_match_the_reference(setups, name):
    _, ref, port, _, _ = setups[name]
    _assert_same(wacky.blockmax_tightness(port), ref_wacky.blockmax_tightness(ref))
    for qmax in (1.0, 40.0):
        _assert_same(wacky.accumulator_overflow(port, qmax),
                     ref_wacky.accumulator_overflow(ref, qmax))


@pytest.mark.parametrize("treatment", ["bm25", "spladev2"])
@pytest.mark.parametrize("bits", [8, 4])
def test_term_statistics_match_the_reference(tiny_corpus, setups, treatment, bits):
    coll = setups[treatment][0]
    args = (coll.doc_idx, coll.term_idx, coll.weights, tiny_corpus.n_docs, coll.query_terms,
            coll.query_weights)
    got = wacky.term_statistics(*args, quant_bits=bits)
    want = ref_wacky.term_statistics(*args, quant_bits=bits)
    _assert_same(got.row(), want.row())


@pytest.mark.parametrize("case", ["gamma", "empty", "constant"])
def test_weight_distribution_stats_match_the_reference(case):
    w = {"gamma": np.random.default_rng(0).gamma(2.0, 1.0, 5000), "empty": np.zeros(7),
         "constant": np.full(10, 3.0)}[case]
    _assert_same(wacky.weight_distribution_stats(w), ref_wacky.weight_distribution_stats(w))


_points = st.lists(
    st.tuples(st.sampled_from([0.1, 0.2, 0.25, 0.3]) | st.floats(0, 1),
              st.sampled_from([1.0, 2.0, 5.0]) | st.floats(0.01, 100),
              st.sampled_from(["bm25", "spladev2"]), st.sampled_from(["saat", "daat"])),
    max_size=25)


def _both(points):
    def build(mod):
        return [mod.OperatingPoint(f"p{i}", m, s, e, lat, {"i": i})
                for i, (e, lat, m, s) in enumerate(points)]
    return build(ref_pareto), build(pareto)


@settings(max_examples=80, deadline=None)
@given(_points)
def test_pareto_matches_the_reference(points):
    ref_pts, port_pts = _both(points)
    assert ([p.name for p in pareto.pareto_frontier(port_pts)]
            == [p.name for p in ref_pareto.pareto_frontier(ref_pts)])
    assert pareto.frontier_table(port_pts) == ref_pareto.frontier_table(ref_pts)
    for rp, pp in zip(ref_pts, port_pts):
        assert ([q.name for q in pareto.dominated_by(pp, port_pts)]
                == [q.name for q in ref_pareto.dominated_by(rp, ref_pts)])
