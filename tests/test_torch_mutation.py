"""The port's mutable index (``IndexHandle``) against the JAX reference's.

Both handles take the same mutation script (adds, updates, deletes) over
the same corpus. Checked:

* ids equal to the reference handle's in every SAAT mode (the port's
  ``"scatter"``, ``"sort"``, ``"kernel"`` and fused beside the reference's
  ``"jnp"``, ``"sort"``, ``"pallas"`` and fused, Pallas in interpret mode)
  and every DAAT mode (against the reference's plain mode, its own
  oracle), with scores within rtol 1e-5;
* mirror-rebuild parity: the port handle answers as a from-scratch rebuild
  of the post-mutation corpus searched with the handle's full live mask
  (the reference's ``tests/test_mutation.py`` oracle), and no tombstoned
  gid comes back;
* compaction: answers equal before and after the fold, and the folded main
  segment is array-equal to the reference's;
* ``executable_key`` tracks the lifecycle and not the generation, and
  equals the reference's key at every step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index_handle import IndexHandle as RefHandle
from repro.serving import AnytimeServer as RefServer
from repro.serving import ServingConfig as RefConfig
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, build_impact_index, daat, saat
from repro_torch.core.index_handle import IndexHandle
from repro_torch.serving import AnytimeServer, ServingConfig

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5
SAAT_MODES = {
    "scatter": (dict(scatter_impl="scatter"), dict(scatter_impl="jnp")),
    "sort": (dict(scatter_impl="sort"), dict(scatter_impl="sort")),
    "kernel": (dict(scatter_impl="kernel"), dict(scatter_impl="pallas")),
    "fused": (dict(fused_topk=True), dict(fused_topk=True)),
}
DAAT_MODES = {
    "plain": dict(),
    "split": dict(use_kernels=True),
    "fused": dict(use_kernels=True, fused_chunk=True),
    "multi": dict(use_kernels=True, fused_chunk=True, trips_per_launch=2),
}
DAAT_KW = dict(est_blocks=4, block_budget=4, exact=True)


def _coo(seed=0, n_docs=80, n_terms=24, nnz=420):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, n_docs, nnz).astype(np.int64)
    t = rng.integers(0, n_terms, nnz).astype(np.int64)
    w = rng.uniform(0.1, 5.0, nnz)
    _, ix = np.unique(d * n_terms + t, return_index=True)
    return d[ix], t[ix], w[ix]


class _Mirror:
    """The raw corpus the handles' logical state must equal."""

    def __init__(self, d, t, w, n_docs):
        self.docs = {gid: (t[d == gid].copy(), w[d == gid].copy()) for gid in range(n_docs)}
        self.next_gid = n_docs
        self.dead: set[int] = set()

    def rebuild(self, handle: IndexHandle):
        """The post-mutation corpus built from scratch on the pinned grid,
        and the handle's full live mask."""
        d, t, w = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)], [np.zeros(0)]
        for gid, (terms, weights) in self.docs.items():
            if gid not in self.dead:
                d.append(np.full(terms.size, gid, np.int64))
                t.append(terms.astype(np.int64))
                w.append(np.asarray(weights, np.float64))
        index = build_impact_index(
            np.concatenate(d), np.concatenate(t), np.concatenate(w), self.next_gid,
            handle.n_terms, quant_max_weight=handle.quant_max_weight,
            block_size=handle.main.block_size, device="cpu",
        )
        live = handle.live_mask_full(int(index.doc_n_terms.shape[0]))
        return index, torch.as_tensor(live)


def _handles(seed=0, n_docs=80, n_terms=24, block_size=16):
    d, t, w = _coo(seed, n_docs, n_terms)
    ref = RefHandle.from_corpus(d, t, w, n_docs, n_terms, block_size=block_size)
    got = IndexHandle.from_corpus(d, t, w, n_docs, n_terms, block_size=block_size, device="cpu")
    return ref, got, _Mirror(d, t, w, n_docs)


def _churn(ref, got, mirror, rng, n_ops=20, n_terms=24):
    """One deterministic add/update/delete script, applied to all three."""
    for _ in range(n_ops):
        op = rng.choice(["add", "update", "delete"], p=[0.4, 0.3, 0.3])
        alive = [g for g in mirror.docs if g not in mirror.dead]
        if not alive and op != "add":
            op = "add"
        if op == "delete":
            gid = int(alive[int(rng.integers(len(alive)))])
            ref.delete(gid)
            got.delete(gid)
            mirror.dead.add(gid)
            continue
        n = int(rng.integers(2, 6))
        terms = rng.choice(n_terms, n, replace=False).astype(np.int64)
        weights = rng.uniform(0.2, 4.0, n)
        if op == "add":
            gid = ref.add(terms, weights)
            assert got.add(terms, weights) == gid == mirror.next_gid
            mirror.next_gid += 1
        else:
            gid = int(alive[int(rng.integers(len(alive)))])
            ref.update(gid, terms, weights)
            got.update(gid, terms, weights)
        mirror.docs[gid] = (terms, weights)


def _queries(rng, n_terms, B=4, lq=5):
    return (rng.integers(0, n_terms, (B, lq)).astype(np.int32),
            rng.uniform(0.1, 2.0, (B, lq)).astype(np.float32))


def _assert_same(got_scores, got_ids, want_scores, want_ids, dead=()):
    """Ids equal at every finite rank (and the same number of finite ranks),
    scores within RTOL/ATOL, no tombstoned gid among them."""
    gs, gi = np.asarray(got_scores), np.asarray(got_ids)
    ws, wi = np.asarray(want_scores), np.asarray(want_ids)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_array_equal(gi[fin], wi[fin])
    np.testing.assert_allclose(gs[fin], ws[fin], rtol=RTOL, atol=ATOL)
    assert not np.isin(gi[fin], sorted(dead)).any()


@pytest.fixture(scope="module")
def churned():
    ref, got, mirror = _handles(seed=1)
    rng = np.random.default_rng(11)
    _churn(ref, got, mirror, rng)
    assert got.delta_docs == ref.delta_docs > 0 and got.tombstone_count == ref.tombstone_count > 0
    np.testing.assert_array_equal(got.live_mask.numpy(), np.asarray(ref.live_mask))
    np.testing.assert_array_equal(got.delta_gids.numpy(), np.asarray(ref.delta_gids))
    return ref, got, mirror, _queries(rng, got.n_terms)


@pytest.mark.parametrize("mode", sorted(SAAT_MODES))
def test_saat_ids_equal_reference_after_churn(churned, mode):
    ref, got, mirror, (qt, qw) = churned
    port_kw, ref_kw = SAAT_MODES[mode]
    for rho in (None, 60):
        want = ref.saat_search(jnp.asarray(qt), jnp.asarray(qw), k=8, rho=rho, **ref_kw)
        res = got.saat_search(qt, qw, k=8, rho=rho, **port_kw)
        _assert_same(res.scores, res.doc_ids, want.scores, want.doc_ids, mirror.dead)
        assert res.delta is not None
    oracle, live = mirror.rebuild(got)
    ex = saat.saat_search(oracle, qt, qw, k=8, rho=saat.exact_rho(oracle),
                          max_segs_per_term=saat.max_segments_per_term(oracle), live_mask=live,
                          **port_kw)
    res = got.saat_search(qt, qw, k=8, **port_kw)
    _assert_same(res.scores, res.doc_ids, ex.scores, ex.doc_ids, mirror.dead)


@pytest.mark.parametrize("mode", sorted(DAAT_MODES))
def test_daat_ids_equal_reference_after_churn(churned, mode):
    ref, got, mirror, (qt, qw) = churned
    want = ref.daat_search(jnp.asarray(qt), jnp.asarray(qw), k=8, **DAAT_KW)
    res = got.daat_search(qt, qw, k=8, **DAAT_KW, **DAAT_MODES[mode])
    _assert_same(res.scores, res.doc_ids, want.scores, want.doc_ids, mirror.dead)
    for f in ("n_survivors", "blocks_scored", "chunks", "rank_safe"):
        np.testing.assert_array_equal(getattr(res.stats, f).numpy(),
                                      np.asarray(getattr(want.stats, f)), err_msg=f)
    oracle, live = mirror.rebuild(got)
    ex = daat.daat_search_batched(oracle, qt, qw, k=8, **DAAT_KW,
                                  max_bm_per_term=daat.max_blocks_per_term(oracle),
                                  live_mask=live, **DAAT_MODES[mode])
    _assert_same(res.scores, res.doc_ids, ex.scores, ex.doc_ids, mirror.dead)


def test_compaction_changes_no_answer_and_matches_reference():
    ref, got, mirror = _handles(seed=3)
    rng = np.random.default_rng(33)
    _churn(ref, got, mirror, rng)
    qt, qw = _queries(rng, got.n_terms)
    before = got.saat_search(qt, qw, k=8)
    before_daat = got.daat_search(qt, qw, k=8, **DAAT_KW, **DAAT_MODES["fused"])
    ref.compact()
    got.compact()
    assert got.generation == ref.generation == 1
    assert got.delta is None and got.delta_docs == 0
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got.main, f).numpy(), np.asarray(getattr(ref.main, f)),
                                      err_msg=f)
    for f in META_FIELDS:
        assert getattr(got.main, f) == getattr(ref.main, f), f
    np.testing.assert_array_equal(got.live_mask.numpy(), np.asarray(ref.live_mask))
    after = got.saat_search(qt, qw, k=8)
    _assert_same(after.scores, after.doc_ids, before.scores, before.doc_ids, mirror.dead)
    after_daat = got.daat_search(qt, qw, k=8, **DAAT_KW, **DAAT_MODES["fused"])
    _assert_same(after_daat.scores, after_daat.doc_ids, before_daat.scores, before_daat.doc_ids)
    oracle, live = mirror.rebuild(got)
    ex = saat.saat_search(oracle, qt, qw, k=8, rho=saat.exact_rho(oracle),
                          max_segs_per_term=saat.max_segments_per_term(oracle), live_mask=live)
    _assert_same(after.scores, after.doc_ids, ex.scores, ex.doc_ids, mirror.dead)
    np.testing.assert_array_equal(np.concatenate(got.export_coo()), np.concatenate(ref.export_coo()))


def test_delete_all_then_compact_serves_nothing():
    ref, got, _ = _handles(seed=4, n_docs=10, n_terms=12)
    for gid in range(10):
        ref.delete(gid)
        got.delete(gid)
    ref.compact()
    got.compact()
    assert not got.main.doc_n_terms.any()
    qt, qw = _queries(np.random.default_rng(44), 12)
    res = got.saat_search(qt, qw, k=4)
    assert not bool(torch.isfinite(res.scores).any())
    for f in ARRAY_FIELDS:
        assert tuple(getattr(got.main, f).shape) == np.shape(getattr(ref.main, f)), f


def test_update_and_delete_inside_the_delta():
    ref, got, mirror = _handles(seed=5, n_docs=20, n_terms=12)
    for h in (ref, got):
        gid = h.add(np.array([1, 3, 5]), np.array([1.0, 2.0, 3.0]))
        h.update(gid, np.array([2, 4]), np.array([5.0, 5.0]))
        assert h.delta_docs == 1
        dead = h.add(np.array([1, 2]), np.array([5.0, 5.0]))
        h.delete(dead)
        assert h.delta_docs == 1
    qt = np.array([[2, 4, 1], [1, 2, 0]], np.int32)
    qw = np.ones((2, 3), np.float32)
    want = ref.saat_search(jnp.asarray(qt), jnp.asarray(qw), k=5)
    res = got.saat_search(qt, qw, k=5)
    _assert_same(res.scores, res.doc_ids, want.scores, want.doc_ids, {dead})
    assert gid in res.doc_ids[0].tolist()


def test_executable_key_tracks_lifecycle_not_generation():
    ref_h, got_h, _ = _handles(seed=9, n_docs=40, n_terms=12)
    cfg = dict(k=4, rho_ladder=(10**9,), lq_buckets=(4,))
    ref = RefServer(ref_h, RefConfig(**cfg))
    got = AnytimeServer(got_h, ServingConfig(**cfg))
    keys = []
    for step in ("start", "delta", "compact"):
        if step == "delta":
            for h in (ref_h, got_h):
                h.add(np.array([1, 2]), np.array([1.0, 2.0]))
        if step == "compact":
            for h, srv in ((ref_h, ref), (got_h, got)):
                h.compact()
                srv.swap_index()
        key = got.executable_key(4, 2, got.rho_ladder[-1])
        assert key == ref.executable_key(4, 2, ref.rho_ladder[-1])
        keys.append(key)
    assert keys[1] != keys[0]  # a delta present is a different dispatch
    assert keys[2] != keys[1]  # folded away again
    assert got.generation == 1
    text = got.export_counters().render()
    for fam in ("repro_index_generation", "repro_index_tombstones", "repro_index_delta_docs"):
        assert fam in text
    assert text == ref.export_counters().render()


def test_service_ema_decays_not_resets_on_swap():
    ref_h, got_h, _ = _handles(seed=7, n_docs=40, n_terms=12)
    cfg = dict(k=4, rho_ladder=(10**9,), lq_buckets=(4,), ema_alpha=0.3)
    ref = RefServer(ref_h, RefConfig(**cfg))
    got = AnytimeServer(got_h, ServingConfig(**cfg))
    for srv in (ref, got):
        srv._observe_bucket_ms(4, 2, 10.0)
        srv._observe_bucket_ms(4, 2, 20.0)
        srv._cost.update(srv.rho_ladder[-1], 50.0)
        srv.swap_index(decay=0.5)
        srv._observe_bucket_ms(4, 2, 30.0)
    assert got._bucket_ms == ref._bucket_ms and got._bucket_conf == ref._bucket_conf
    assert got._cost.confidence == ref._cost.confidence
