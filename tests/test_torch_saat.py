"""The port's SAAT engine against the JAX reference's, mode for mode.

Each port mode runs beside the reference mode it ports, on one index:
``fused_topk=True`` (the fused kernel) against the reference's fused Pallas
kernel, ``"kernel"`` against ``"pallas"``, ``"sort"`` against ``"sort"`` and
``"scatter"`` against ``"jnp"``. The Pallas modes run in interpret mode, as
the reference's own tests run them on the CPU; the port's kernel modes run
their plain PyTorch versions, since the tensors lie on the CPU.

Ids and both posting counts must be equal. Scores agree within rtol 1e-5 /
atol 1e-5 (the Pallas one-hot dot reassociates each doc's sum). The
fixtures are the reference's own (``tests/conftest.py``), on which the
reference's modes agree on ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core import exact_rho as ref_exact_rho
from repro.core import exhaustive_search as ref_exhaustive
from repro.core import pad_queries as ref_pad_queries
from repro.core import saat_search as ref_saat
from repro.core.saat import max_segments_per_term as ref_max_segs
from repro_torch.core import (
    build_impact_index,
    exact_rho,
    exhaustive_search,
    max_segments_per_term,
    saat_plan,
    saat_search,
)

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5
# port mode -> (port keywords, reference keywords)
MODES = {
    "fused": (dict(fused_topk=True), dict(fused_topk=True)),
    "kernel": (dict(scatter_impl="kernel"), dict(scatter_impl="pallas")),
    "sort": (dict(scatter_impl="sort"), dict(scatter_impl="sort")),
    "scatter": (dict(scatter_impl="scatter"), dict(scatter_impl="jnp")),
}
RHO_LADDER = (100, 500, 2000, "exact", "beyond")


def _pair(ref_index, enc, n_docs):
    port = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, n_docs, enc.n_terms,
                              device="cpu")
    max_q = max(len(t) for t in enc.query_terms)
    qt, qw = ref_pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
    return ref_index, port, qt, qw


@pytest.fixture(scope="module")
def indexes(tiny_corpus, bm25_collection, splade_collection, bm25_index):
    enc = splade_collection
    splade_ref = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    return {
        "bm25": _pair(bm25_index, bm25_collection, tiny_corpus.n_docs),
        "spladev2": _pair(splade_ref, enc, tiny_corpus.n_docs),
    }


def _rho(index, qt, qw, rho):
    """"exact" is the batch's largest candidate count: rank-safe for every
    query in it (``saat_search`` stops at each query's own total)."""
    if rho not in ("exact", "beyond"):
        return rho
    ms = max_segments_per_term(index)
    exact = int(saat_plan(index, torch.as_tensor(qt), torch.as_tensor(qw), ms).total_postings.max())
    return exact if rho == "exact" else 2 * exact


def _assert_parity(ref_index, port_index, qt, qw, mode, *, k, rho, live=None):
    port_kw, ref_kw = MODES[mode]
    ms = ref_max_segs(ref_index)
    assert max_segments_per_term(port_index) == ms
    want = ref_saat(ref_index, jnp.asarray(qt), jnp.asarray(qw), k=k, rho=rho,
                    max_segs_per_term=ms, live_mask=None if live is None else jnp.asarray(live),
                    **ref_kw)
    got = saat_search(port_index, qt, qw, k=k, rho=rho, max_segs_per_term=ms,
                      live_mask=None if live is None else torch.as_tensor(live), **port_kw)
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_array_equal(got.postings_processed.numpy(), np.asarray(want.postings_processed))
    np.testing.assert_array_equal(got.total_postings.numpy(), np.asarray(want.total_postings))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL)
    return got


@pytest.mark.parametrize("rho", RHO_LADDER)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_saat_rho_ladder(indexes, model, mode, rho):
    ref_index, port_index, qt, qw = indexes[model]
    r = _rho(port_index, qt, qw, rho)
    assert exact_rho(port_index) == ref_exact_rho(ref_index)
    got = _assert_parity(ref_index, port_index, qt, qw, mode, k=10, rho=r)
    if rho == "beyond":
        assert bool((got.postings_processed == got.total_postings).all())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_saat_ragged_batch_with_pad_terms(indexes, mode):
    ref_index, port_index, qt, qw = indexes["bm25"]
    qt, qw = np.array(qt[:8]), np.array(qw[:8])
    for i in range(qt.shape[0]):
        keep = max(1, qt.shape[1] - i)
        qw[i, keep:] = 0.0
        qt[i, keep:] = ref_index.n_terms
    qw[3] = 0.0  # an all-pad row
    qt[3] = ref_index.n_terms
    got = _assert_parity(ref_index, port_index, qt, qw, mode, k=10, rho=2000)
    assert int(got.total_postings[3]) == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_saat_duplicate_and_zero_weight_terms(indexes, mode):
    ref_index, port_index, qt, qw = indexes["spladev2"]
    qt, qw = np.array(qt[:6]), np.array(qw[:6])
    qt[:, 1] = qt[:, 0]  # duplicate term: contributes per slot
    qw[:, 2] = 0.0  # zero-weight real term: contributes nothing
    _assert_parity(ref_index, port_index, qt, qw, mode, k=10, rho=1000)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_saat_k_exceeds_n_docs(mode):
    rng = np.random.default_rng(5)
    n_docs, n_terms = 50, 30
    d, t, w = rng.integers(0, n_docs, 400), rng.integers(0, n_terms, 400), rng.gamma(2.0, 1.0, 400)
    ref_index = ref_build(d, t, w, n_docs, n_terms)
    port_index = build_impact_index(d, t, w, n_docs, n_terms, device="cpu")
    qt = rng.integers(0, n_terms, (3, 4)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, (3, 4)).astype(np.float32)
    got = _assert_parity(ref_index, port_index, qt, qw, mode, k=n_docs + 10,
                         rho=ref_exact_rho(ref_index))
    assert bool(torch.isneginf(got.scores[:, n_docs:]).all())


@pytest.mark.parametrize("mode", sorted(MODES))
def test_saat_live_mask(indexes, mode):
    ref_index, port_index, qt, qw = indexes["bm25"]
    live = (np.random.default_rng(1).random(ref_index.doc_terms.shape[0]) < 0.6).astype(np.int32)
    got = _assert_parity(ref_index, port_index, qt, qw, mode, k=10, rho=2000, live=live)
    assert bool((torch.as_tensor(live)[got.doc_ids.long()] != 0).all())


def test_saat_batch_of_one_and_plan(indexes):
    ref_index, port_index, qt, qw = indexes["bm25"]
    _assert_parity(ref_index, port_index, qt[:1], qw[:1], "fused", k=5, rho=300)
    from repro.core.saat import saat_plan as ref_plan

    ms = ref_max_segs(ref_index)
    want = ref_plan(ref_index, jnp.asarray(qt), jnp.asarray(qw), ms)
    got = saat_plan(port_index, torch.as_tensor(qt), torch.as_tensor(qw), ms)
    for f in ("starts", "contribs", "cum_len", "total_postings"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def test_saat_rejects_unbatched_input(indexes):
    _, port_index, qt, qw = indexes["bm25"]
    with pytest.raises(ValueError, match="B, Lq"):
        saat_search(port_index, qt[0], qw[0], k=5, rho=100, max_segs_per_term=4)
    with pytest.raises(ValueError, match="scatter_impl"):
        saat_search(port_index, qt, qw, k=5, rho=100, max_segs_per_term=4, scatter_impl="jnp")


@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_exhaustive_ids_equal_reference(indexes, model):
    ref_index, port_index, qt, qw = indexes[model]
    want = ref_exhaustive(ref_index, jnp.asarray(qt), jnp.asarray(qw), k=10)
    got = exhaustive_search(port_index, qt, qw, k=10)
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL)
    # the SAAT engine at a rank-safe rho returns the oracle's ids
    fused = saat_search(port_index, qt, qw, k=10, rho=exact_rho(port_index),
                        max_segs_per_term=max_segments_per_term(port_index), fused_topk=True)
    np.testing.assert_array_equal(fused.doc_ids.numpy(), got.doc_ids.numpy())
