"""The port's block-max DAAT engine against the JAX reference's.

Every port mode, plain (``use_kernels=False``), split (``use_kernels=True``),
fused (``fused_chunk=True``) and multi-trip (``trips_per_launch`` 2, 3, 8),
runs beside the reference's plain jnp mode on one index, the parity oracle
the reference itself holds its kernel modes to. On CPU tensors the port's
kernel modes run the kernels' plain PyTorch versions.

Ids and all four ``WorkStats`` must be equal; scores agree within rtol 1e-5 /
atol 1e-5 (sums over a doc's terms are taken in another order). The
fixtures are the reference's own (``tests/conftest.py``, and the 7-block
index of ``tests/test_chunk_step.py``), on which the reference's modes
agree on ids.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core import daat_search_batched as ref_daat
from repro.core import pad_queries as ref_pad_queries
from repro.core.daat import block_upper_bounds as ref_block_upper_bounds
from repro.core.daat import max_blocks_per_term as ref_max_bm
from repro_torch.core import (
    ARRAY_FIELDS,
    META_FIELDS,
    block_upper_bounds,
    daat_search_batched,
    daat_search_vmap,
    exhaustive_search,
    index_from_numpy,
    max_blocks_per_term,
)

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5
MODES = {
    "plain": dict(),
    "split": dict(use_kernels=True),
    "fused": dict(use_kernels=True, fused_chunk=True),
    "multi2": dict(use_kernels=True, fused_chunk=True, trips_per_launch=2),
    "multi3": dict(use_kernels=True, fused_chunk=True, trips_per_launch=3),
    "multi8": dict(use_kernels=True, fused_chunk=True, trips_per_launch=8),
}
STATS = ("n_survivors", "blocks_scored", "chunks", "rank_safe")


def _port_index(ref_index):
    arrays = {f: np.asarray(getattr(ref_index, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(ref_index, f) for f in META_FIELDS}
    return index_from_numpy(arrays, meta, device="cpu")


def _random_index(seed, n_docs, n_terms, n_postings, block_size=128):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, n_docs, n_postings)
    t = rng.integers(0, n_terms, n_postings)
    w = rng.gamma(2.0, 1.0, n_postings)
    return ref_build(d, t, w, n_docs, n_terms, block_size=block_size)


@pytest.fixture(scope="module")
def setups(tiny_corpus, bm25_collection, splade_collection, bm25_index, bm25_queries):
    """name -> (reference index, port index, q_terms, q_weights, live, kwargs)."""
    enc = splade_collection
    splade = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    max_q = max(len(t) for t in enc.query_terms)
    sqt, sqw = ref_pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
    bqt, bqw = (np.array(a) for a in bm25_queries)
    bm25 = (bm25_index, _port_index(bm25_index))
    spl = (splade, _port_index(splade))
    base = dict(k=10, est_blocks=2, block_budget=2)
    out = {}
    for exact in (True, False):
        tag = "exact" if exact else "approx"
        out[f"bm25_{tag}"] = (*bm25, bqt, bqw, None, dict(base, exact=exact))
        out[f"spladev2_{tag}"] = (*spl, sqt, sqw, None, dict(base, exact=exact))
        # rows with progressively more pad terms ride one batch
        qt, qw = bqt[:8].copy(), bqw[:8].copy()
        for i in range(qt.shape[0]):
            keep = max(1, qt.shape[1] - i)
            qw[i, keep:] = 0.0
            qt[i, keep:] = bm25_index.n_terms
        out[f"ragged_pad_terms_{tag}"] = (*bm25, qt, qw, None,
                                          dict(base, block_budget=1, exact=exact))
        small = _random_index(5, 50, 30, 400)
        rng = np.random.default_rng(5)
        qt = rng.integers(0, 30, (3, 4)).astype(np.int32)
        qw = rng.gamma(1.0, 1.0, (3, 4)).astype(np.float32)
        out[f"k_exceeds_n_docs_{tag}"] = (small, _port_index(small), qt, qw, None,
                                          dict(k=60, est_blocks=small.n_blocks, block_budget=1,
                                               exact=exact))
    qt, qw = bqt[:4].copy(), bqw[:4].copy()
    qt[:, 1] = qt[:, 0]
    out["duplicate_terms"] = (*bm25, qt, qw, None, dict(base, exact=True))
    qt, qw = bqt[:4].copy(), bqw[:4].copy()
    qw[:, 1] = 0.0
    out["zero_weight_terms"] = (*bm25, qt, qw, None, dict(base, exact=True))
    qt, qw = bqt[:4].copy(), bqw[:4].copy()
    qw[2], qt[2] = 0.0, bm25_index.n_terms
    out["all_pad_row"] = (*bm25, qt, qw, None, dict(base, exact=True))
    out["max_chunks_cap"] = (*bm25, bqt, bqw, None,
                             dict(k=10, est_blocks=1, block_budget=1, exact=True, max_chunks=1))
    out["batch_of_one"] = (*bm25, bqt[:1], bqw[:1], None,
                           dict(k=5, est_blocks=1, block_budget=1, exact=True))
    rng = np.random.default_rng(21)
    n_pad = int(bm25_index.doc_terms.shape[0])
    live = (rng.random(n_pad) < 0.7).astype(np.int32)
    live[:128] = 0  # one whole dead block leaves selection after phase 0
    out["live_bm25"] = (*bm25, bqt, bqw, live, dict(base, exact=True))
    out["live_spladev2"] = (*spl, sqt, sqw, live, dict(base, exact=True))
    # the 7-block, bs=32 index of tests/test_chunk_step.py: more phase-2 trips
    seven = _random_index(0, 220, 40, 1500, block_size=32)
    rng = np.random.default_rng(31)
    qt = rng.integers(0, 40, (5, 6)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, (5, 6)).astype(np.float32)
    qt[1, 1] = qt[1, 0]
    qw[3, 2] = 0.0
    live7 = (rng.random(7 * 32) < 0.8).astype(np.int32)
    for budget in (1, 3):
        out[f"seven_blocks_budget{budget}"] = (seven, _port_index(seven), qt, qw, None,
                                               dict(k=5, est_blocks=2, block_budget=budget))
    out["seven_blocks_live"] = (seven, _port_index(seven), qt, qw, live7,
                                dict(k=5, est_blocks=2, block_budget=2))
    out["seven_blocks_k_at_pool"] = (seven, _port_index(seven), qt, qw, None,
                                     dict(k=64, est_blocks=2, block_budget=3))
    return out


_REF_CACHE: dict = {}


def _reference(name, setup):
    if name not in _REF_CACHE:
        ref_index, _, qt, qw, live, kw = setup
        _REF_CACHE[name] = ref_daat(
            ref_index, jnp.asarray(qt), jnp.asarray(qw),
            max_bm_per_term=ref_max_bm(ref_index), use_kernels=False,
            live_mask=None if live is None else jnp.asarray(live), **kw,
        )
    return _REF_CACHE[name]


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids), err_msg=what)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL, atol=ATOL,
                               err_msg=what)
    for field in STATS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=f"{what}: WorkStats.{field}")


CASES = (
    "bm25_exact", "bm25_approx", "spladev2_exact", "spladev2_approx",
    "ragged_pad_terms_exact", "ragged_pad_terms_approx",
    "k_exceeds_n_docs_exact", "k_exceeds_n_docs_approx",
    "duplicate_terms", "zero_weight_terms", "all_pad_row", "max_chunks_cap", "batch_of_one",
    "live_bm25", "live_spladev2",
    "seven_blocks_budget1", "seven_blocks_budget3", "seven_blocks_live", "seven_blocks_k_at_pool",
)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_daat_matches_reference_jnp_mode(setups, case, mode):
    setup = setups[case]
    _, port_index, qt, qw, live, kw = setup
    want = _reference(case, setup)
    got = daat_search_batched(
        port_index, torch.as_tensor(qt), torch.as_tensor(qw),
        max_bm_per_term=max_blocks_per_term(port_index),
        live_mask=None if live is None else torch.as_tensor(live), **kw, **MODES[mode],
    )
    assert got.doc_ids.dtype == torch.int32 and got.chunks.dtype == torch.int32
    _assert_same(got, want, f"{case} {mode}")
    if case == "k_exceeds_n_docs_exact":
        assert bool(torch.isneginf(got.scores[:, 50:]).all())
    if case == "max_chunks_cap":
        assert int(got.chunks.max()) <= 1
    if case == "all_pad_row":
        assert int(got.n_survivors[2]) == 0


@pytest.mark.parametrize("treatment", ["bm25", "spladev2"])
def test_block_upper_bounds_equal_reference_bit_for_bit(setups, treatment):
    ref_index, port_index, qt, qw, _, _ = setups[f"{treatment}_exact"]
    mb = max_blocks_per_term(port_index)
    assert mb == ref_max_bm(ref_index)
    want = ref_block_upper_bounds(ref_index, jnp.asarray(qt), jnp.asarray(qw), mb)
    got = block_upper_bounds(port_index, torch.as_tensor(qt), torch.as_tensor(qw), mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = block_upper_bounds(port_index, torch.as_tensor(qt[3]), torch.as_tensor(qw[3]), mb)
    np.testing.assert_array_equal(one.numpy(), np.asarray(want)[3])


@pytest.mark.parametrize("case", ["bm25_exact", "bm25_approx", "spladev2_exact",
                                  "seven_blocks_live", "max_chunks_cap"])
def test_vmap_oracle_matches_batched_engine(setups, case):
    _, port_index, qt, qw, live, kw = setups[case]
    kw = dict(kw, max_bm_per_term=max_blocks_per_term(port_index),
              live_mask=None if live is None else torch.as_tensor(live))
    b = daat_search_batched(port_index, torch.as_tensor(qt), torch.as_tensor(qw), **kw)
    v = daat_search_vmap(port_index, torch.as_tensor(qt), torch.as_tensor(qw), **kw)
    assert torch.equal(b.doc_ids, v.doc_ids)
    torch.testing.assert_close(b.scores, v.scores, rtol=RTOL, atol=ATOL)
    for field in STATS:
        assert torch.equal(getattr(b, field), getattr(v, field)), field


@pytest.mark.parametrize("treatment", ["bm25", "spladev2"])
def test_exact_daat_equals_exhaustive(setups, treatment):
    _, port_index, qt, qw, _, kw = setups[f"{treatment}_exact"]
    qt, qw = torch.as_tensor(qt), torch.as_tensor(qw)
    ex = exhaustive_search(port_index, qt, qw, k=10)
    for mode in ("plain", "fused"):
        d = daat_search_batched(port_index, qt, qw, max_bm_per_term=max_blocks_per_term(port_index),
                                **kw, **MODES[mode])
        assert bool(d.rank_safe.all())
        torch.testing.assert_close(d.scores, ex.scores, rtol=RTOL, atol=ATOL)
        # equal scores may come in either order (DAAT keeps pool order, the
        # oracle doc order), and docs tied with the k-th may be either: with
        # ties ordered by id, the ids above the k-th score are equal
        above = ex.scores > ex.scores[:, -1:]
        assert torch.equal(_by_score_then_id(d)[above], _by_score_then_id(ex)[above])


def _by_score_then_id(res):
    ids = res.doc_ids.long()
    order = torch.sort(ids, dim=-1, stable=True).indices
    order = torch.gather(order, -1, torch.sort(torch.gather(res.scores, -1, order), dim=-1,
                                               descending=True, stable=True).indices)
    return torch.gather(ids, -1, order)


@pytest.mark.parametrize("flags,match", [
    (dict(fused_chunk=True), "use_kernels"),
    (dict(use_kernels=True, trips_per_launch=2), "fused_chunk"),
    (dict(use_kernels=True, fused_chunk=True, trips_per_launch=0), "trips_per_launch"),
    (dict(k=10_000, est_blocks=1), "est_blocks"),
])
def test_flag_rules_raise(setups, flags, match):
    _, port_index, qt, qw, _, _ = setups["bm25_exact"]
    kw = dict(k=5, est_blocks=2, block_budget=2, max_bm_per_term=max_blocks_per_term(port_index))
    with pytest.raises(ValueError, match=match):
        daat_search_batched(port_index, qt[:2], qw[:2], **{**kw, **flags})


def test_unbatched_queries_raise(setups):
    _, port_index, qt, qw, _, _ = setups["bm25_exact"]
    with pytest.raises(ValueError, match="B, Lq"):
        daat_search_batched(port_index, qt[0], qw[0], k=5, est_blocks=2, block_budget=2,
                            max_bm_per_term=max_blocks_per_term(port_index))
