"""The port's admission queue, lifecycle replay and effectiveness harness
against the JAX reference's, on a simulated clock.

Time is a ``SimulatedClock`` in both packages (the port's HybridClock reads
real time, so it never decides here), arrival schedules come from seeded
numpy RNGs, and the same requests go to both:

* a seeded 500-request Poisson ``replay_arrivals``: equal ``FlushRecord``s
  (time, bucket, shape, rids, reason, rho, predicted service, violation)
  and equal completion ids, for SAAT and for DAAT (the survivor sort);
* a degrading queue under a scripted service model: equal degradation
  decisions, and ``replay_effectiveness`` / ``effectiveness_surface`` give
  equal numbers;
* bucketing: ids and scores equal to the max-Lq pad in the port, both
  engines;
* ``replay_with_churn``: an equal churn ledger, equal flush generations and
  equal completion ids.
"""
import numpy as np
import pytest
import torch

from repro.core.index_handle import IndexHandle as RefHandle
from repro.metrics import ir_metrics as ref_ir
from repro.metrics.latency import SimulatedClock as RefSimulatedClock
from repro.serving import AdmissionQueue as RefQueue
from repro.serving import AnytimeServer as RefServer
from repro.serving import CompactionPolicy as RefPolicy
from repro.serving import Compactor as RefCompactor
from repro.serving import MutationEvent as RefMutation
from repro.serving import ServingConfig as RefConfig
from repro.serving import replay_with_churn as ref_replay_with_churn
from repro.serving.queue import replay_arrivals as ref_replay_arrivals
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, index_from_numpy
from repro_torch.core.index_handle import IndexHandle
from repro_torch.metrics import ir_metrics
from repro_torch.metrics.latency import HybridClock, SimulatedClock
from repro_torch.serving import (
    AdmissionQueue,
    AnytimeServer,
    CompactionPolicy,
    Compactor,
    MutationEvent,
    ServingConfig,
    replay_arrivals,
    replay_with_churn,
)

pytestmark = pytest.mark.torch_port

EXACT = (10**9,)


def _port(ref_index):
    arrays = {f: np.asarray(getattr(ref_index, f)) for f in ARRAY_FIELDS}
    return index_from_numpy(arrays, {f: getattr(ref_index, f) for f in META_FIELDS},
                            device="cpu")


@pytest.fixture(scope="module")
def bm25(bm25_index, bm25_queries):
    return bm25_index, _port(bm25_index), *(np.asarray(a) for a in bm25_queries)


def _servers(bm25, *, engine="saat", buckets=None, script=None, **cfg_kw):
    """The same server in both packages, each on its own simulated clock;
    ``script`` seeds both shape-keyed service EMAs."""
    ref_index, port, qt, _ = bm25
    L = qt.shape[1]
    cfg = dict(dict(k=10, rho_ladder=EXACT, engine=engine, daat_est_blocks=2,
                    daat_block_budget=2, lq_buckets=buckets if buckets is not None else (2, 4, L)),
               **cfg_kw)
    ref = RefServer(ref_index, RefConfig(**cfg), clock=RefSimulatedClock())
    got = AnytimeServer(port, ServingConfig(**cfg), clock=SimulatedClock())
    for srv in (ref, got):
        srv._bucket_ms.update(script(srv.rho_ladder) if script else {})
    return ref, got


def _mixed_lq_requests(qt, qw, n, rng):
    L = qt.shape[1]
    widths = rng.choice([1, 2, 3, L], size=n, p=[0.2, 0.3, 0.2, 0.3])
    picks = rng.integers(0, qt.shape[0], size=n)
    return ([np.asarray(qt[q, :w]) for q, w in zip(picks, widths)],
            [np.asarray(qw[q, :w]) for q, w in zip(picks, widths)])


def _flush_rows(log):
    return [(f.flush_s, f.bucket, f.batch_shape, f.n_real, f.rids, f.rho, f.predicted_ms,
             f.oldest_deadline_s, f.reason, f.violation, f.infeasible, f.generation) for f in log]


def _assert_same_replay(ref_q, got_q, ref_comps, got_comps):
    assert _flush_rows(got_q.flush_log) == _flush_rows(ref_q.flush_log)
    assert [c.rid for c in got_comps] == [c.rid for c in ref_comps]
    for g, r in zip(got_comps, ref_comps):
        np.testing.assert_array_equal(g.doc_ids, np.asarray(r.doc_ids))
        np.testing.assert_allclose(g.scores, np.asarray(r.scores), rtol=1e-5, atol=1e-5)
        assert (g.arrival_s, g.flush_s, g.deadline_s, g.bucket, g.batch_shape, g.rho) == (
            r.arrival_s, r.flush_s, r.deadline_s, r.bucket, r.batch_shape, r.rho)
    for attr in ("n_submitted", "n_completed", "n_violations", "n_infeasible", "n_degraded"):
        assert getattr(got_q, attr) == getattr(ref_q, attr), attr


@pytest.mark.parametrize("engine,n,shapes", [("saat", 500, (4, 16)), ("daat", 120, (4, 8))])
def test_poisson_replay_equal_flushes_and_ids(bm25, engine, n, shapes):
    _, _, qt, qw = bm25
    rng = np.random.default_rng(7)
    terms, weights = _mixed_lq_requests(qt, qw, n, rng)
    arrivals = np.cumsum(rng.exponential(0.002, size=n)).tolist()
    deadlines = rng.uniform(20.0, 60.0, size=n).tolist()
    ref, got = _servers(bm25, engine=engine)
    ref_q = RefQueue(ref, batch_shapes=shapes, clock=ref.clock)
    got_q = AdmissionQueue(got, batch_shapes=shapes, clock=got.clock)
    ref_comps = ref_replay_arrivals(ref_q, arrivals, terms, weights, deadlines)
    got_comps = replay_arrivals(got_q, arrivals, terms, weights, deadlines)
    _assert_same_replay(ref_q, got_q, ref_comps, got_comps)
    assert sorted(c.rid for c in got_comps) == list(range(n))
    assert got_q.n_violations == 0
    if engine == "daat":
        assert got_q.survivors._by_lq == ref_q.survivors._by_lq


def _scripted_service(L):
    """Whole-flush wall ms per (shape, level): only the smallest and the full
    level are calibrated, and full-rho service cannot meet a tight burst."""
    def script(ladder):
        small, full = ladder[0], ladder[-1]
        return {("saat", L, 2, full): 20.0, ("saat", L, 4, full): 60.0,
                ("saat", L, 2, small): 5.0, ("saat", L, 4, small): 15.0}
    return script


def test_degrading_replay_effectiveness_equal(tiny_corpus, bm25):
    """Two bursts (loose then tight deadlines) through a degrading queue:
    the same flushes degrade in both, and the effectiveness report by served
    rho is equal number for number."""
    _, _, qt, qw = bm25
    L = qt.shape[1]
    qrels = np.asarray(tiny_corpus.qrels)[:8]
    arrivals = [0.0, 0.001, 0.002, 0.003, 0.050, 0.051, 0.052, 0.053]
    deadlines = [200.0] * 4 + [30.0] * 4
    reps = []
    for pkg, queue_cls, ir in (("ref", RefQueue, ref_ir), ("port", AdmissionQueue, ir_metrics)):
        ref, got = _servers(bm25, buckets=(L,), script=_scripted_service(L),
                            rho_ladder=(200, 1000) + EXACT)
        srv = ref if pkg == "ref" else got
        q = queue_cls(srv, batch_shapes=(2, 4), clock=srv.clock, degrade_rho=True)
        reps.append(ir.replay_effectiveness(q, arrivals, [qt[i] for i in range(8)],
                                            [qw[i] for i in range(8)], deadlines, qrels,
                                            recall_k=10))
    want, got = reps
    assert got == want
    assert got["degraded_flushes"] == 1 and got["violations"] == 0


def test_effectiveness_surface_equal(tiny_corpus, bm25):
    _, _, qt, qw = bm25
    L = qt.shape[1]
    qrels = np.asarray(tiny_corpus.qrels)[:4]

    def factory(queue_cls, pkg):
        def make(_deadline_ms):
            ref, got = _servers(bm25, buckets=(L,), script=_scripted_service(L),
                                rho_ladder=(200, 1000) + EXACT)
            srv = ref if pkg == "ref" else got
            return queue_cls(srv, batch_shapes=(2, 4), clock=srv.clock, degrade_rho=True)
        return make

    args = ([200.0, 30.0], [0.0, 0.001, 0.002, 0.003], [qt[i] for i in range(4)],
            [qw[i] for i in range(4)], qrels)
    want = ref_ir.effectiveness_surface(factory(RefQueue, "ref"), *args, recall_k=10)
    got = ir_metrics.effectiveness_surface(factory(AdmissionQueue, "port"), *args, recall_k=10)
    assert got == want
    assert got[1]["degraded_flushes"] >= 1


@pytest.mark.parametrize("engine", ["saat", "daat"])
def test_bucketed_serving_equals_max_lq_pad(bm25, engine):
    _, port, qt, qw = bm25
    L = qt.shape[1]
    base = dict(k=10, rho_ladder=EXACT, engine=engine, daat_est_blocks=2, daat_block_budget=2)
    plain = AnytimeServer(port, ServingConfig(**base), clock=SimulatedClock())
    bucketed = AnytimeServer(port, ServingConfig(**base, lq_buckets=(2, 4, L)),
                             clock=SimulatedClock())
    for lo in range(0, qt.shape[0], 8):
        bt, bw = qt[lo:lo + 8].copy(), qw[lo:lo + 8].copy()
        bt[:, 3:], bw[:, 3:] = port.n_terms, 0.0  # a short batch: bucket 4
        a = plain.search_batch(bt, bw)
        b = bucketed.search_batch(bt, bw)
        assert torch.equal(a.doc_ids, b.doc_ids) and torch.equal(a.scores, b.scores)
    assert {key[1] for key in bucketed._bucket_ms} == {4}


def test_replay_with_churn_equal_ledger():
    """The reference suite's hot-swap replay (17 queries, 8 adds, threshold
    compaction) in both packages: equal mutation ledgers, flush generations
    and completion ids, and nothing lost."""
    rng = np.random.default_rng(8)
    n_docs, n_terms = 60, 16
    d = rng.integers(0, n_docs, 300).astype(np.int64)
    t = rng.integers(0, n_terms, 300).astype(np.int64)
    w = rng.uniform(0.1, 5.0, 300)
    _, ix = np.unique(d * n_terms + t, return_index=True)
    d, t, w = d[ix], t[ix], w[ix]
    n = 17
    arrivals = np.cumsum(rng.uniform(0.004, 0.012, n)).tolist()
    qts = [rng.integers(0, n_terms, 5).astype(np.int32) for _ in range(n)]
    qws = [rng.uniform(0.1, 2.0, 5).astype(np.float32) for _ in range(n)]
    mrng = np.random.default_rng(99)
    events = []
    for i in range(10):
        t_s = arrivals[0] + (arrivals[-1] - arrivals[0]) * (i + 0.5) / 10
        if i % 4 == 3:
            events.append(dict(t_s=t_s, op="delete", gid=int(mrng.integers(n_docs))))
            continue
        nterm = int(mrng.integers(2, 5))
        events.append(dict(t_s=t_s, op="add",
                           terms=mrng.choice(n_terms, nterm, replace=False).astype(np.int64),
                           weights=mrng.uniform(0.2, 4.0, nterm)))
    out = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            handle = RefHandle.from_corpus(d, t, w, n_docs, n_terms, block_size=16)
            srv_cls, cfg_cls, clock = RefServer, RefConfig, RefSimulatedClock()
            q_cls, pol, comp_cls, mut, replay = (RefQueue, RefPolicy, RefCompactor, RefMutation,
                                                 ref_replay_with_churn)
        else:
            handle = IndexHandle.from_corpus(d, t, w, n_docs, n_terms, block_size=16,
                                             device="cpu")
            srv_cls, cfg_cls, clock = AnytimeServer, ServingConfig, SimulatedClock()
            q_cls, pol, comp_cls, mut, replay = (AdmissionQueue, CompactionPolicy, Compactor,
                                                 MutationEvent, replay_with_churn)
        srv = srv_cls(handle, cfg_cls(k=5, rho_ladder=EXACT, lq_buckets=(5,), batch_size=4),
                      clock=clock)
        queue = q_cls(srv, batch_shapes=(2, 4), clock=clock, max_wait_s=0.02)
        compactor = comp_cls(queue, handle, pol(max_delta_docs=3, min_tombstones=2,
                                                max_tombstone_frac=0.05))
        comps, mlog = replay(queue, handle, arrivals, qts, qws, [50.0] * n,
                             [mut(**ev) for ev in events], compactor=compactor)
        out.append((queue, comps, mlog, compactor, handle))
    (ref_q, ref_comps, ref_log, ref_c, ref_h), (got_q, got_comps, got_log, got_c, got_h) = out
    assert got_log == ref_log
    assert got_c.log == ref_c.log and got_c.n_compactions == ref_c.n_compactions >= 1
    _assert_same_replay(ref_q, got_q, ref_comps, got_comps)
    assert sorted(c.rid for c in got_comps) == list(range(n))
    assert got_h.generation == ref_h.generation
    assert got_h.dead_gids == ref_h.dead_gids


def test_hybrid_clock_accrues_real_work():
    import time

    c = HybridClock(5.0)
    t0 = c.now()
    time.sleep(0.01)
    assert c.now() - t0 >= 0.009
    assert c.advance_to(100.0) >= 100.0 and c.advance_to(0.0) >= 100.0
    assert isinstance(c, SimulatedClock)  # accepted by replay_arrivals
