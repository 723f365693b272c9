"""The port's DAAT kernel wrappers (plain path on the CPU) against the JAX
reference, at every shape of the reference kernels' ``CONTRACT.shape_grid``,
on the same numpy inputs.

* ``block_prune_csr`` against the reference's ``ref.py``: masks equal, bounds
  within rtol 1e-5 (the reference oracle contracts with a dot); on a real
  index the bounds equal the reference engine's scatter-add bit for bit.
* ``block_topk`` against the reference's ops in interpret mode, on inputs
  full of ties and ``-inf``: ids and scores equal.
* ``sparse_score`` against the reference's ops in interpret mode, duplicate
  and zero-weight query terms included: within rtol 1e-5 / atol 1e-5; its
  store-addressed entry (the split mode's scorer, rows read in place)
  against the reference's ``_score_blocks_kernel_batched`` (gather, then the
  kernel in interpret mode, then the masks) on real and tiny indexes with
  pad docs and a tombstone bitmap: within rtol 1e-6, ``-inf`` where and only
  where the reference has it.
* ``chunk_step`` and ``chunk_step_multi`` against the reference's jnp
  oracles (``chunk_step/ref.py``), not the Pallas kernel in interpret mode,
  which differs from its own oracle by an ulp on this box. The oracles take
  no tombstone bitmap, so the live-masked cases are held against the same
  trip composed of the reference engine's jnp pieces (``topk``,
  ``score_blocks`` with ``live_mask``, ``merge_topk``). Ids, ``processed``
  and ``trips_done`` equal; scores and theta within rtol 1e-5 / atol 1e-5.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core import pad_queries
from repro.core.daat import block_upper_bounds as ref_block_upper_bounds
from repro.core.daat import csr_blockmax_offsets as ref_csr_offsets
from repro.core.daat import _score_blocks_kernel_batched as ref_score_blocks_kernel
from repro.core.daat import daat_plan, max_blocks_per_term, score_blocks
from repro.core.topk import merge_topk as ref_merge_topk
from repro.core.topk import topk as ref_topk
from repro.kernels.block_prune_csr import ops as ref_prune_ops
from repro.kernels.block_prune_csr.ref import block_prune_csr_batched_ref
from repro.kernels.block_topk import ops as ref_topk_ops
from repro.kernels.chunk_step import ops as ref_chunk_ops
from repro.kernels.chunk_step.ref import chunk_step_batched_ref, chunk_step_multi_batched_ref
from repro.kernels.sparse_score import ops as ref_score_ops
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, index_from_numpy
from repro_torch.core import daat_plan as port_daat_plan
from repro_torch.core import max_blocks_per_term as port_max_bm
from repro_torch.core import score_blocks as port_score_blocks
from repro_torch.core.daat import _score_blocks_kernel_batched as port_score_blocks_kernel
from repro_torch.core.topk import topk as port_topk
from repro_torch.kernels.block_prune_csr import ops as prune_ops
from repro_torch.kernels.block_topk import ops as topk_ops
from repro_torch.kernels.chunk_step import ops as chunk_ops
from repro_torch.kernels.sparse_score import ops as score_ops

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# block_prune_csr
# ---------------------------------------------------------------------------


def _csr_inputs(d, seed):
    """CSR block-max lists of random terms (sorted unique block ids, some
    lists longer than the per-term bound M, which the wrapper clamps), and
    per-(query, slot) windows into them, a fifth of them empty pad slots."""
    rng = np.random.default_rng(seed)
    nb, m, n_bm = d["nb"], d["m"], d["n_bm"]
    starts, counts, total = [], [], 0
    bm_block = np.zeros(n_bm, np.int32)
    while True:
        c = int(min(rng.integers(1, 2 * m + 1), nb))
        if total + c > n_bm:
            break
        bm_block[total:total + c] = np.sort(rng.choice(nb, c, replace=False))
        starts.append(total)
        counts.append(c)
        total += c
    bm_weight = np.zeros(n_bm, np.float32)
    bm_weight[:total] = rng.gamma(1.0, 1.0, total)
    terms = rng.integers(0, len(starts), (d["batch"], d["lq"]))
    base = np.asarray(starts, np.int32)[terms]
    cnt = np.asarray(counts, np.int32)[terms]
    qw = rng.gamma(1.0, 1.0, terms.shape).astype(np.float32)
    empty = rng.random(terms.shape) < 0.2
    base[empty], cnt[empty], qw[empty] = total, 0, 0.0
    theta = rng.uniform(0.0, 2.0, d["batch"]).astype(np.float32)
    theta[0] = -np.inf  # a pure bound pass, as the engine's
    return bm_block, bm_weight, base, cnt, qw, theta


@pytest.mark.parametrize("case", ref_prune_ops.CONTRACT.shape_grid, ids=lambda c: c.name)
def test_block_prune_csr_contract_shapes(case):
    d = case.dims
    args = _csr_inputs(d, seed=len(case.name))
    kw = dict(n_blocks=d["nb"], max_bm_per_term=d["m"])
    want_ub, want_mask = block_prune_csr_batched_ref(*(jnp.asarray(a) for a in args), **kw)
    got_ub, got_mask = prune_ops.block_prune_csr_batched(*(_t(a) for a in args), **kw)
    assert got_ub.dtype == torch.float32 and got_mask.dtype == torch.bool
    np.testing.assert_allclose(got_ub.numpy(), np.asarray(want_ub), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize("index_name", ["bm25_index_q", "splade_index"])
def test_block_prune_csr_bounds_equal_reference_scatter_bit_for_bit(request, index_name):
    index, qt, qw = request.getfixturevalue(index_name)
    mb = max_blocks_per_term(index)
    base, cnt = ref_csr_offsets(index, qt, qw, mb)
    got, _ = prune_ops.block_prune_csr_batched(
        _t(index.bm_block), _t(index.bm_weight), _t(base), _t(cnt), _t(qw),
        torch.full((qt.shape[0],), float("-inf")), n_blocks=index.n_blocks, max_bm_per_term=mb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_block_upper_bounds(index, qt, qw, mb)))


@pytest.fixture(scope="module")
def splade_index(tiny_corpus, splade_collection):
    enc = splade_collection
    index = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    qt, qw = _padded(enc)
    return index, qt, qw


@pytest.fixture(scope="module")
def bm25_index_q(bm25_index, bm25_queries):
    return bm25_index, jnp.asarray(bm25_queries[0]), jnp.asarray(bm25_queries[1])


def _padded(enc):
    max_q = max(len(t) for t in enc.query_terms)
    qt, qw = pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
    return jnp.asarray(qt), jnp.asarray(qw)


# ---------------------------------------------------------------------------
# block_topk
# ---------------------------------------------------------------------------


def _tied_scores(shape, seed):
    """Few distinct values, so most scores tie; a tenth of them -inf."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = -np.inf
    return s


@pytest.mark.parametrize("case", ref_topk_ops.CONTRACT.shape_grid, ids=lambda c: c.name)
def test_block_topk_contract_shapes(case):
    d = case.dims
    batched = "batch" in d
    scores = _tied_scores((d["batch"], d["n"]) if batched else (d["n"],), seed=len(case.name))
    ref_fn = ref_topk_ops.block_topk_batched if batched else ref_topk_ops.block_topk
    port_fn = topk_ops.block_topk_batched if batched else topk_ops.block_topk
    want_s, want_i = ref_fn(jnp.asarray(scores), d["k"], tile=d["tile"], interpret=True)
    got_s, got_i = port_fn(_t(scores), d["k"], tile=d["tile"])
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("k,n", [(50, 40), (3, 300)])
def test_block_topk_all_neg_inf_rows_and_k_past_n(k, n):
    scores = _tied_scores((3, n), seed=k)
    scores[1] = -np.inf
    want_s, want_i = ref_topk_ops.block_topk_batched(jnp.asarray(scores), k, tile=128,
                                                     interpret=True)
    got_s, got_i = topk_ops.block_topk_batched(_t(scores), k, tile=128)
    assert got_s.shape == (3, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# sparse_score
# ---------------------------------------------------------------------------


def _score_inputs(d, seed):
    """A 50-term vocabulary, so doc terms match often; every query repeats
    its first term in slot 1 and carries a zero-weight slot."""
    rng = np.random.default_rng(seed)
    lead = (d["batch"],) if "batch" in d else ()
    dt = rng.integers(0, 50, lead + (d["n"], d["tmax"])).astype(np.int32)
    dw = rng.gamma(1.0, 1.0, dt.shape).astype(np.float32)
    qt = rng.integers(0, 50, lead + (d["lq"],)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, qt.shape).astype(np.float32)
    if d["lq"] > 1:
        qt[..., 1] = qt[..., 0]
    if d["lq"] > 2:
        qw[..., 2] = 0.0
    return dt, dw, qt, qw


@pytest.mark.parametrize("case", ref_score_ops.CONTRACT.shape_grid, ids=lambda c: c.name)
def test_sparse_score_contract_shapes(case):
    d = case.dims
    args = _score_inputs(d, seed=len(case.name))
    batched = "batch" in d
    ref_fn = ref_score_ops.sparse_score_batched if batched else ref_score_ops.sparse_score
    port_fn = score_ops.sparse_score_batched if batched else score_ops.sparse_score
    want = ref_fn(*(jnp.asarray(a) for a in args), block_d=d["block_d"], interpret=True)
    got = port_fn(*(_t(a) for a in args))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_sparse_score_duplicate_query_terms_sum():
    got = score_ops.sparse_score(torch.tensor([[3, 5]], dtype=torch.int32),
                                 torch.tensor([[2.0, 1.0]]),
                                 torch.tensor([3, 3], dtype=torch.int32), torch.tensor([1.0, 0.5]))
    assert got.tolist() == [3.0]


def _store_case(request, name, seed):
    """A reference index, the port's copy of it, queries (the tiny index's
    repeat a term and carry a zero-weight slot) and each query's selected
    blocks, always with the last block, whose tail holds pad docs."""
    rng = np.random.default_rng(seed)
    if name == "tiny":
        ref, port = _tiny_index()
        qt = rng.integers(0, 40, (5, 6)).astype(np.int32)
        qw = rng.gamma(1.0, 1.0, qt.shape).astype(np.float32)
        qt[:, 1], qw[:, 2] = qt[:, 0], 0.0
        qt, qw = jnp.asarray(qt), jnp.asarray(qw)
    else:
        ref, qt, qw = request.getfixturevalue(name)
        port = index_from_numpy({f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS},
                                {f: getattr(ref, f) for f in META_FIELDS}, device="cpu")
    assert ref.n_docs < ref.doc_terms.shape[0]  # the last block holds pad docs
    nb = min(3, ref.n_blocks)
    ids = np.stack([np.concatenate([[ref.n_blocks - 1],
                                    rng.choice(ref.n_blocks - 1, nb - 1, replace=False)])
                    for _ in range(qt.shape[0])])
    return ref, port, qt, qw, rng.permuted(ids, axis=1).astype(np.int32)


@pytest.mark.parametrize("live,gate", [(False, False), (True, False), (True, True)],
                         ids=["all", "live", "live_gate"])
@pytest.mark.parametrize("name", ["tiny", "splade_index", "bm25_index_q"])
def test_sparse_score_store_entry_matches_reference_gather_and_score(request, name, live, gate):
    ref, port, qt, qw, ids = _store_case(request, name, seed=len(name))
    rng = np.random.default_rng(7)
    mask = (rng.random(ref.doc_terms.shape[0]) < 0.7).astype(np.int32) if live else None
    block_live = rng.random(ids.shape) < 0.6 if gate else None
    want_s, want_d = ref_score_blocks_kernel(ref, qt, qw, jnp.asarray(ids),
                                             None if mask is None else jnp.asarray(mask))
    want_s = np.asarray(want_s)
    if gate:
        want_s = np.where(block_live[..., None], want_s, -np.inf)
    qw_raw = torch.where(_t(qw) > 0, _t(qw), 0.0)
    got = score_ops.sparse_score_blocks_batched(
        port.doc_terms, port.doc_weights, _t(ids), _t(qt), qw_raw, block_size=port.block_size,
        n_live=port.n_docs, live=None if mask is None else _t(mask),
        block_live=None if block_live is None else _t(block_live))
    got_s, got_d = port_score_blocks_kernel(port, _t(qt), _t(qw), _t(ids),
                                            None if mask is None else _t(mask),
                                            None if block_live is None else _t(block_live))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert np.isfinite(want_s).any() and not np.isfinite(want_s).all()
    for g in (got.reshape(want_s.shape), got_s):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(np.isneginf(g.numpy()), np.isneginf(want_s))
        np.testing.assert_allclose(g.numpy(), want_s, rtol=1e-6)


# ---------------------------------------------------------------------------
# chunk_step (B4) and chunk_step_multi (B5)
# ---------------------------------------------------------------------------

_INDEX_CACHE: dict = {}


def _tiny_index(seed=0, n_docs=220, n_terms=40, n_postings=1500, block_size=32):
    """The 7-block index of tests/test_chunk_step.py (220 docs, bs=32)."""
    key = (seed, n_docs, n_terms, n_postings, block_size)
    if key not in _INDEX_CACHE:
        rng = np.random.default_rng(seed)
        d = rng.integers(0, n_docs, n_postings)
        t = rng.integers(0, n_terms, n_postings)
        w = rng.gamma(2.0, 1.0, n_postings)
        ref = ref_build(d, t, w, n_docs, n_terms, block_size=block_size)
        port = index_from_numpy({f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS},
                                {f: getattr(ref, f) for f in META_FIELDS}, device="cpu")
        _INDEX_CACHE[key] = (ref, port)
    return _INDEX_CACHE[key]


def _phase1_state(port_idx, qt, qw, *, k, est_blocks=2):
    """The engine's phase-1 seeding, as tests/test_chunk_step.py builds it
    (here with the port's plain pieces, whose bounds equal the reference's
    bit for bit), as numpy arrays for both packages."""
    qt, qw = torch.as_tensor(qt), torch.as_tensor(qw)
    ub, qvec = port_daat_plan(port_idx, qt, qw, port_max_bm(port_idx))
    B = qt.shape[0]
    _, b1 = port_topk(ub, est_blocks)
    s1, d1 = port_score_blocks(port_idx, qvec, b1)
    pool_s, pos = port_topk(s1.reshape(B, -1), k)
    pool_i = torch.gather(d1.reshape(B, -1), -1, pos).to(torch.int32)
    processed = torch.zeros((B, port_idx.n_blocks), dtype=torch.bool)
    processed.scatter_(1, b1, True)
    return tuple(t.numpy() for t in (ub, processed, pool_s, pool_i, pool_s[:, k - 1]))


# the reference's jnp oracles, compiled once per shape
_JIT_TRIP = jax.jit(chunk_step_batched_ref,
                    static_argnames=("block_budget", "block_size", "n_live", "n_terms"))
_JIT_MULTI = jax.jit(chunk_step_multi_batched_ref, static_argnames=(
    "trips_per_launch", "block_budget", "block_size", "n_live", "n_terms"))


def _ref_trip_live(idx, qt, qw, state, live, *, budget):
    """One trip of the reference engine's jnp body with a tombstone bitmap."""
    return jax.jit(partial(_ref_trip_live_body, idx, budget=budget))(qt, qw, state, live)


def _ref_trip_live_body(idx, qt, qw, state, live, *, budget):
    ub, processed, pool_s, pool_i, theta = state
    B, k = pool_s.shape
    qvec = daat_plan(idx, qt, qw, max_blocks_per_term(idx)).qvec
    ub_c, b_c = ref_topk(jnp.where(processed, -jnp.inf, ub), budget)
    lv = ub_c > theta[:, None]
    s_c, d_c = score_blocks(idx, qvec, b_c, live)
    s_c = jnp.where(lv[..., None], s_c, -jnp.inf)
    ms, mi = ref_merge_topk(pool_s, pool_i, s_c.reshape(B, -1),
                            d_c.reshape(B, -1).astype(jnp.int32), k)
    rows = jnp.arange(B)[:, None]
    return ms, mi, ms[:, k - 1], processed.at[rows, b_c].set(processed[rows, b_c] | lv)


def _ref_multi_live(idx, qt, qw, state, live, trips_left, *, budget, trips):
    ub, processed, pool_s, pool_i, theta = state
    done = jnp.zeros(trips_left.shape, jnp.int32)
    trip = jax.jit(partial(_ref_trip_live_body, idx, budget=budget))
    for t in range(trips):
        act = (t < trips_left) & (jnp.max(jnp.where(processed, -jnp.inf, ub), axis=-1) > theta)
        ns, ni, nth, npr = trip(qt, qw, (ub, processed, pool_s, pool_i, theta), live)
        pool_s = jnp.where(act[:, None], ns, pool_s)
        pool_i = jnp.where(act[:, None], ni, pool_i)
        theta = jnp.where(act, nth, theta)
        processed = jnp.where(act[:, None], npr, processed)
        done = done + act.astype(jnp.int32)
    return pool_s, pool_i, theta, processed, done


def _assert_state(got, want, what):
    names = ("pool_s", "pool_i", "theta", "processed", "trips_done")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name in ("pool_s", "theta"):
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {name}")


def _chunk_case(d, seed, *, theta_above=False, dup_zero=False):
    ref_idx, port_idx = _tiny_index(n_docs=d["n_docs"], block_size=d["block_size"])
    rng = np.random.default_rng(seed)
    qt = rng.integers(0, ref_idx.n_terms, (d["B"], d["lq"])).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, (d["B"], d["lq"])).astype(np.float32)
    if dup_zero:
        qt[:, 1] = qt[:, 0]
        qw[:, 2] = 0.0
        qt[-1], qw[-1] = ref_idx.n_terms, 0.0  # an all-pad row
    state = _phase1_state(port_idx, qt, qw, k=d["k"], est_blocks=d.get("est_blocks", 2))
    if theta_above:
        state = state[:4] + (np.full((d["B"],), float(state[0].max()) + 1.0, np.float32),)
    live = None
    if d.get("live"):
        live = (rng.random(ref_idx.doc_terms.shape[0]) < 0.7).astype(np.int32)
    return ref_idx, port_idx, qt, qw, state, live


EXTRA_CASES = (
    ("all_pruned", dict(B=3, budget=3, k=4, n_docs=220, block_size=32, lq=5), dict(theta_above=True)),
    ("dup_zero_pad_terms", dict(B=4, budget=3, k=4, n_docs=220, block_size=32, lq=6), dict(dup_zero=True)),
    ("k_at_pool", dict(B=2, budget=3, k=64, n_docs=220, block_size=32, lq=5), {}),
    ("multi_k_at_pool", dict(B=2, trips=3, budget=2, k=64, n_docs=220, block_size=32, lq=5), {}),
    ("multi_live_b3_trips8", dict(B=3, trips=8, budget=3, k=5, n_docs=220, block_size=32, lq=6,
                                  live=1), {}),
)
CHUNK_CASES = [(c.name, c.dims, {}) for c in ref_chunk_ops.CONTRACT.shape_grid] + list(EXTRA_CASES)


@pytest.mark.parametrize("name,dims,opts", CHUNK_CASES, ids=[c[0] for c in CHUNK_CASES])
def test_chunk_step_against_reference_oracle(name, dims, opts):
    ref_idx, port_idx, qt, qw, state, live = _chunk_case(dims, seed=len(name) * 7 + dims["B"],
                                                         **opts)
    budget = dims["budget"]
    qw_raw = np.where(qw > 0, qw, 0.0).astype(np.float32)
    port_state = tuple(_t(s) for s in state)
    common = dict(block_budget=budget, block_size=ref_idx.block_size, n_live=ref_idx.n_docs)
    port_args = (port_idx.doc_terms, port_idx.doc_weights, _t(qt), _t(qw_raw), *port_state)
    ref_args = (ref_idx.doc_terms, ref_idx.doc_weights, jnp.asarray(qt), jnp.asarray(qw),
                *(jnp.asarray(a) for a in state))
    port_live = None if live is None else _t(live)
    if "trips" in dims:
        trips = dims["trips"]
        trips_left = np.arange(dims["B"], dtype=np.int32) % (trips + 1)  # 0 freezes a row
        got = chunk_ops.chunk_step_multi_batched(*port_args, _t(trips_left), trips_per_launch=trips,
                                                 live=port_live, **common)
        if live is None:
            want = _JIT_MULTI(*ref_args, jnp.asarray(trips_left),
                                                trips_per_launch=trips, n_terms=ref_idx.n_terms,
                                                **common)
        else:
            want = _ref_multi_live(ref_idx, jnp.asarray(qt), jnp.asarray(qw), ref_args[4:],
                                   jnp.asarray(live), jnp.asarray(trips_left), budget=budget,
                                   trips=trips)
        assert got[4].dtype == torch.int32
    else:
        got = chunk_ops.chunk_step_batched(*port_args, live=port_live, **common)
        if live is None:
            want = _JIT_TRIP(*ref_args, n_terms=ref_idx.n_terms, **common)
        else:
            want = _ref_trip_live(ref_idx, jnp.asarray(qt), jnp.asarray(qw), ref_args[4:],
                                  jnp.asarray(live), budget=budget)
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.bool
    _assert_state(got, want, name)
    if opts.get("theta_above"):  # nothing live: the state rides through unchanged
        assert torch.equal(got[1], port_state[3]) and torch.equal(got[3], port_state[1])


def test_chunk_step_rejects_budget_past_n_blocks_and_zero_trips():
    ref_idx, port_idx, qt, qw, state, _ = _chunk_case(
        dict(B=2, budget=2, k=3, n_docs=220, block_size=32, lq=4), seed=6)
    args = (port_idx.doc_terms, port_idx.doc_weights, _t(qt), _t(qw), *(_t(s) for s in state))
    common = dict(block_size=32, n_live=ref_idx.n_docs)
    with pytest.raises(ValueError, match="n_blocks"):
        chunk_ops.chunk_step_batched(*args, block_budget=ref_idx.n_blocks + 1, **common)
    with pytest.raises(ValueError, match="trips_per_launch"):
        chunk_ops.chunk_step_multi_batched(*args, torch.ones(2, dtype=torch.int32),
                                           trips_per_launch=0, block_budget=2, **common)
