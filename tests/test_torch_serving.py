"""The port's serving layer against the JAX reference's.

* The controller: from the same scripted observations (a scripted clock
  under ``search_batch``, and direct EMA updates), ``pick_rho``,
  ``pick_degraded_rho``, ``predict_service_ms``, the cost model's EMA and
  ``executable_key`` give equal outputs in both packages.
* ``run_query_stream``: equal ids (scores within rtol 1e-5) in every SAAT
  mode (the port's ``"scatter"``, ``"sort"``, ``"kernel"`` and fused beside
  the reference's ``"jnp"``, ``"sort"``, ``"pallas"`` and fused, Pallas in
  interpret mode) and in the DAAT modes, with and without Lq buckets.
* ``saat_search_vmap``: equal ids in each mode, and equal to the port's
  batched engine.

The fixtures are the reference's own (``tests/conftest.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core import pad_queries as ref_pad_queries
from repro.core.saat import max_segments_per_term as ref_max_segs
from repro.core.saat import saat_search_vmap as ref_saat_vmap
from repro.metrics.latency import SimulatedClock as RefSimulatedClock
from repro.serving import AnytimeServer as RefServer
from repro.serving import ServingConfig as RefConfig
from repro.serving import run_query_stream as ref_run_query_stream
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, index_from_numpy, saat_search
from repro_torch.core.saat import saat_search_vmap
from repro_torch.metrics.latency import SimulatedClock
from repro_torch.serving import AnytimeServer, ServingConfig, run_query_stream

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5
EXACT = (10**9,)
# port mode -> (port ServingConfig keywords, reference ServingConfig keywords)
SAAT_MODES = {
    "scatter": (dict(scatter_impl="scatter"), dict(scatter_impl="jnp")),
    "sort": (dict(scatter_impl="sort"), dict(scatter_impl="sort")),
    "kernel": (dict(scatter_impl="kernel"), dict(scatter_impl="pallas")),
    "fused": (dict(fused_topk=True), dict(fused_topk=True)),
}
DAAT_BASE = dict(engine="daat", daat_est_blocks=2, daat_block_budget=2)
DAAT_MODES = {
    "plain": dict(),
    "split": dict(daat_use_kernels=True),
    "fused": dict(daat_use_kernels=True, daat_fused_chunk=True),
    "multi": dict(daat_use_kernels=True, daat_fused_chunk=True, daat_trips_per_launch=3),
}


def port_index(ref_index):
    arrays = {f: np.asarray(getattr(ref_index, f)) for f in ARRAY_FIELDS}
    return index_from_numpy(arrays, {f: getattr(ref_index, f) for f in META_FIELDS},
                            device="cpu")


@pytest.fixture(scope="module")
def setups(tiny_corpus, bm25_collection, splade_collection, bm25_index, bm25_queries):
    enc = splade_collection
    splade = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    max_q = max(len(t) for t in enc.query_terms)
    sqt, sqw = ref_pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
    return {
        "bm25": (bm25_index, port_index(bm25_index), *(np.asarray(a) for a in bm25_queries)),
        "spladev2": (splade, port_index(splade), np.asarray(sqt), np.asarray(sqw)),
    }


class _ScriptedClock:
    """Clock whose now() returns a scripted sequence (pads with the last)."""

    def __init__(self, times):
        self.times = list(times)
        self.i = 0

    def now(self) -> float:
        t = self.times[min(self.i, len(self.times) - 1)]
        self.i += 1
        return t


def _pair(setup, *, clock_factory=None, **cfg_kw):
    """The same server in both packages, each on its own clock."""
    ref_index, port, _, _ = setup
    ref = RefServer(ref_index, RefConfig(**cfg_kw),
                    clock=clock_factory() if clock_factory else RefSimulatedClock())
    got = AnytimeServer(port, ServingConfig(**cfg_kw),
                        clock=clock_factory() if clock_factory else SimulatedClock())
    return ref, got


def test_controller_decisions_equal_from_scripted_service_times(setups):
    """Six batches through search_batch on one scripted clock per server
    (each SAAT call reads it three times: start, stop, calibration stamp),
    then direct observations of other shapes and levels: every EMA and
    every decision of the controller equals the reference's."""
    _, _, qt, qw = setups["bm25"]
    L = qt.shape[1]
    times, t = [], 0.0
    for dt in (0.004, 0.011, 0.006, 0.019, 0.009, 0.013):
        times += [t, t + dt, t + dt]
        t += dt + 0.001
    cfg = dict(k=5, rho_ladder=(200, 1000, 5000) + EXACT, lq_buckets=(4, L))
    ref, got = _pair(setups["bm25"], clock_factory=lambda: _ScriptedClock(times), **cfg)
    rhos = (200, 1000, None, 200, 5000, None)
    shapes = (8, 8, 16, 16, 8, 4)
    for i, (rho, B) in enumerate(zip(rhos, shapes)):
        rows = np.resize(np.arange(qt.shape[0]), B) + i
        rows %= qt.shape[0]
        rr = ref.search_batch(jnp.asarray(qt[rows]), jnp.asarray(qw[rows]), rho=rho)
        gr = got.search_batch(qt[rows], qw[rows], rho=rho)
        np.testing.assert_array_equal(gr.doc_ids.numpy(), np.asarray(rr.doc_ids))
    for srv in (ref, got):
        srv._observe_bucket_ms(4, 8, 3.0, rho=200)
        srv._observe_bucket_ms(4, 32, 7.5, rho=5000)
        srv._cost.update(1000, 2400.0)
    assert got._bucket_ms == ref._bucket_ms
    assert got._bucket_conf == ref._bucket_conf
    assert got._latencies_ms == ref._latencies_ms and got._rhos == ref._rhos
    assert got._cost.us_per_mpost == ref._cost.us_per_mpost
    assert got._cost.last_update_s == ref._cost.last_update_s
    assert got.rho_ladder == ref.rho_ladder
    for deadline in (None, 1e-6, 0.05, 0.2, 0.5, 1.0, 3.0, 1e9):
        assert got.pick_rho(deadline_ms=deadline) == ref.pick_rho(deadline_ms=deadline)
    for bucket in (4, L, L + 3):
        for n in (1, 4, 8, 12, 16, 40):
            for rho in (None,) + got.rho_ladder:
                assert got.predict_service_ms(n, bucket, rho) == ref.predict_service_ms(
                    n, bucket, rho)
            for remaining in (0.0, 2.0, 5.0, 9.0, 20.0, 100.0):
                assert got.pick_degraded_rho(n, bucket, remaining) == ref.pick_degraded_rho(
                    n, bucket, remaining)
        for rho in (None,) + got.rho_ladder:
            assert got.service_calibrated(bucket, rho) == ref.service_calibrated(bucket, rho)
            for B in (4, 8, 32):
                assert got.executable_key(bucket, B, rho) == ref.executable_key(bucket, B, rho)
    got.cfg = ServingConfig(**dict(cfg, deadline_ms=0.6))
    ref.cfg = RefConfig(**dict(cfg, deadline_ms=0.6))
    assert got.pick_rho() == ref.pick_rho()


@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_daat_executable_key_equals_reference(setups, mode):
    ref, got = _pair(setups["spladev2"], k=10, **DAAT_BASE, **DAAT_MODES[mode])
    for B in (1, 8):
        assert got.executable_key(7, B) == ref.executable_key(7, B)
    assert got.predict_service_ms(8, 7) == ref.predict_service_ms(8, 7) == 0.0


def test_server_rejects_the_reference_scatter_names(setups):
    _, port, _, _ = setups["bm25"]
    for name in ("jnp", "pallas"):
        with pytest.raises(ValueError, match="scatter_impl"):
            AnytimeServer(port, ServingConfig(scatter_impl=name))


def _streams_equal(got, want):
    gs, gi = got
    ws, wi = want
    np.testing.assert_array_equal(gi, np.asarray(wi))
    np.testing.assert_allclose(gs, np.asarray(ws), rtol=RTOL, atol=ATOL)


SAAT_STREAMS = ([(model, mode, None) for model in ("bm25", "spladev2") for mode in sorted(SAAT_MODES)]
                + [("spladev2", mode, (4, 8)) for mode in ("fused", "sort")])


@pytest.mark.parametrize("model,mode,buckets", SAAT_STREAMS)
def test_run_query_stream_saat_ids_equal(setups, model, mode, buckets):
    """One batch of 8 queries at the top level, then at a deadline that
    picks the small level (a ragged final batch: the test below)."""
    _, _, qt, qw = setups[model]
    qt, qw = qt[:8], qw[:8]
    port_kw, ref_kw = SAAT_MODES[mode]
    base = dict(k=10, rho_ladder=(300,) + EXACT, batch_size=8, lq_buckets=buckets)
    ref = RefServer(setups[model][0], RefConfig(**base, **ref_kw), clock=RefSimulatedClock())
    got = AnytimeServer(setups[model][1], ServingConfig(**base, **port_kw), clock=SimulatedClock())
    for rho in (None, 300):
        if rho is not None:  # a fixed deadline that picks the small level in both
            for srv in (ref, got):
                srv._cost.update(300, 1.0)
                srv._cost.update(srv.rho_ladder[-1], 1e9)
            ref.cfg = RefConfig(**base, **ref_kw, deadline_ms=1.0)
            got.cfg = ServingConfig(**base, **port_kw, deadline_ms=1.0)
        _streams_equal(run_query_stream(got, qt, qw), ref_run_query_stream(ref, qt, qw))
    assert got._rhos == ref._rhos


@pytest.mark.parametrize("mode", sorted(DAAT_MODES))
def test_run_query_stream_daat_ids_equal(setups, mode):
    """The reference's plain DAAT mode is the oracle of every mode (its own
    tests hold its kernel modes to it). Two batches of 8."""
    _, _, qt, qw = setups["spladev2"]
    qt, qw = qt[:16], qw[:16]
    base = dict(k=10, batch_size=8, **DAAT_BASE)
    ref = RefServer(setups["spladev2"][0], RefConfig(**base), clock=RefSimulatedClock())
    got = AnytimeServer(setups["spladev2"][1], ServingConfig(**base, **DAAT_MODES[mode]),
                        clock=SimulatedClock())
    _streams_equal(run_query_stream(got, qt, qw), ref_run_query_stream(ref, qt, qw))


def test_run_query_stream_ragged_final_batch(setups):
    _, _, qt, qw = setups["bm25"]
    srv = AnytimeServer(setups["bm25"][1], ServingConfig(k=10, rho_ladder=EXACT, batch_size=4),
                        clock=SimulatedClock())
    scores, ids = run_query_stream(srv, qt[:10], qw[:10])
    one = srv.search_batch(qt[:10], qw[:10])
    np.testing.assert_array_equal(ids, one.doc_ids.numpy())
    np.testing.assert_array_equal(scores, one.scores.numpy())
    assert len(srv._latencies_ms) == 12 + 10  # 3 batches of 4, then the direct call


@pytest.mark.parametrize("mode", ["scatter", "sort", "kernel"])
@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_saat_search_vmap_ids_equal(setups, model, mode):
    ref_index, port, qt, qw = setups[model]
    port_kw, ref_kw = SAAT_MODES[mode]
    ms = ref_max_segs(ref_index)
    rows = slice(0, 10)
    for rho in (150, 1200):
        want = ref_saat_vmap(ref_index, jnp.asarray(qt[rows]), jnp.asarray(qw[rows]), k=10,
                             rho=rho, max_segs_per_term=ms, **ref_kw)
        got = saat_search_vmap(port, qt[rows], qw[rows], k=10, rho=rho, max_segs_per_term=ms,
                               **port_kw)
        np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=RTOL,
                                   atol=ATOL)
        for f in ("postings_processed", "total_postings"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        batched = saat_search(port, qt[rows], qw[rows], k=10, rho=rho, max_segs_per_term=ms,
                              **port_kw)
        assert torch.equal(batched.doc_ids, got.doc_ids)


def test_saat_search_vmap_live_mask(setups):
    ref_index, port, qt, qw = setups["bm25"]
    live = (np.random.default_rng(2).random(port.doc_terms.shape[0]) < 0.6).astype(np.int32)
    ms = ref_max_segs(ref_index)
    want = ref_saat_vmap(ref_index, jnp.asarray(qt[:6]), jnp.asarray(qw[:6]), k=8, rho=600,
                         max_segs_per_term=ms, live_mask=jnp.asarray(live))
    got = saat_search_vmap(port, qt[:6], qw[:6], k=8, rho=600, max_segs_per_term=ms,
                           live_mask=torch.as_tensor(live))
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    assert bool((torch.as_tensor(live)[got.doc_ids.long()] != 0).all())


def test_exact_level_clamp_leaves_results_unchanged(setups):
    """At ``rho >= n_postings`` the gather stops at the batch's largest
    total: the same ids, scores and counts as a budget just above it."""
    _, port, qt, qw = setups["spladev2"]
    ms = int(port.max_segs)
    from repro_torch.core import saat_plan

    top = int(saat_plan(port, torch.as_tensor(qt), torch.as_tensor(qw), ms).total_postings.max())
    for kw in (dict(fused_topk=True), dict(scatter_impl="sort")):
        a = saat_search(port, qt, qw, k=10, rho=port.n_postings, max_segs_per_term=ms, **kw)
        b = saat_search(port, qt, qw, k=10, rho=top + 7, max_segs_per_term=ms, **kw)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
