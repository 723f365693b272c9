"""The port's pod serving against the JAX reference.

* **Every pod layout of ``tests/test_pod.py``** on the port's in-process
  mesh, held to the reference's unsharded oracle (exact ``saat_search`` on
  one index): SAAT at (1, 1), (1, 2), (2, 4), (4, 2) and (8, 1) over the
  ragged 37-doc corpus; DAAT on distinct scores at (1, 1) and (2, 2); the
  all-equal-score tie order at (1, 1), (2, 1), (3, 1) and (2, 2), bit for
  bit; bucketed routing and ``.statics``; and, beyond the reference's
  grid, a live-masked pod step at (2, 2) against the masked oracle. The
  reference's own tests at layouts above (1, 1) need 8 forced host devices
  and skip on one CPU device; the port is held to the oracle they assert.
* **The host side at (1, 1) against the reference's**: ``PodServer``'s
  per-shard rho ladder; ``executable_key`` equal to the reference's, with
  the pod identity in it, tracking the lifecycle and not the generation;
  ``PodFrontEnd`` end to end (each completion equal to the reference
  front end's and to a direct call of the pod step) at (1, 1), and at
  (2, 2) to the direct step and the oracle; the exported counters equal to
  the reference front end's; a tombstone stack plus a delta pool, then
  ``swap_stack`` to the compacted generation, equal to the reference's
  ``PodServer`` and to the port's ``IndexHandle``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh

from repro.core import build_impact_index as ref_build
from repro.core.index_handle import IndexHandle as RefHandle
from repro.core.saat import max_segments_per_term as ref_max_segs
from repro.core.saat import saat_search as ref_saat_search
from repro.metrics.latency import SimulatedClock as RefSimulatedClock
from repro.serving import PodFrontEnd as RefFrontEnd
from repro.serving import PodServer as RefPodServer
from repro.serving import ServingConfig as RefConfig
from repro.serving import shard_corpus as ref_shard_corpus
from repro.serving import stack_indexes as ref_stack
from repro_torch.core.index_handle import IndexHandle
from repro_torch.metrics.latency import SimulatedClock
from repro_torch.serving import (
    PodFrontEnd,
    PodServer,
    ServingConfig,
    make_bucketed_serve_step,
    make_pod_serve_step,
    pod_hosts,
    shard_corpus,
    shard_live_stack,
    stack_indexes,
    warmup_pod,
)
from test_torch_sharded import coo, cpu_mesh, queries

pytestmark = [pytest.mark.torch_port, pytest.mark.pod]

I32_MAX = np.iinfo(np.int32).max


def pod_mesh(n_pod, n_model):
    return cpu_mesh((n_pod, n_model), ("pod", "model"))


def ref_pod_mesh():
    return RefMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("pod", "model"))


def oracle(d, t, w, n_docs, n_terms, qt, qw, k, live_full=None):
    """The reference's unsharded exact SAAT (``tests/test_pod.py``): one
    accumulator, one top-k, ties to the lower id."""
    idx = ref_build(d, t, w, n_docs, n_terms)
    lm = None
    if live_full is not None:
        lm = np.zeros(int(idx.doc_n_terms.shape[0]), np.int32)
        lm[:n_docs] = live_full
        lm = jnp.asarray(lm)
    res = ref_saat_search(idx, jnp.asarray(qt), jnp.asarray(qw), k=k, rho=idx.n_postings,
                          max_segs_per_term=ref_max_segs(idx), live_mask=lm)
    return np.asarray(res.scores), np.asarray(res.doc_ids)


def pod_step(mesh, shards, dps, n_docs, k, **kw):
    stack = stack_indexes(shards)
    kw.setdefault("rho_per_shard", int(stack.doc_ids.shape[1]))
    kw.setdefault("max_segs_per_term", stack.max_segs)
    serve, _, _ = make_pod_serve_step(mesh, k=k, docs_per_shard=dps, n_docs_total=n_docs, **kw)
    return serve, stack


# ---------------------------------------------------------------------------
# (b) every pod layout against the unsharded oracle
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saat_case():
    d, t, w, n_docs, n_terms = coo()
    qt, qw = queries(7, n_terms)
    return (d, t, w, n_docs, n_terms), (qt, qw), oracle(d, t, w, n_docs, n_terms, qt, qw, 10)


@pytest.mark.parametrize("layout", [(1, 1), (1, 2), (2, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("route", ["sort", "fused"])
def test_pod_saat_equals_the_oracle(saat_case, layout, route):
    (d, t, w, n_docs, n_terms), (qt, qw), (os_, oi) = saat_case
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, layout[0] * layout[1], device="cpu")
    serve, stack = pod_step(pod_mesh(*layout), shards, dps, n_docs, 10,
                            fused_topk=route == "fused")
    ss, si = serve(stack, qt, qw)
    np.testing.assert_allclose(ss.numpy(), os_, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(si.numpy(), oi)


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
@pytest.mark.parametrize("mode", ["plain", "fused"])
def test_pod_daat_equals_the_oracle_on_distinct_scores(layout, mode):
    n_docs, n_terms, B, k = 23, 8, 4, 6
    d = np.arange(n_docs, dtype=np.int32)
    t = np.zeros(n_docs, dtype=np.int32)
    w = (d + 1).astype(np.float32) * 0.5  # doc-unique, quant-distinct
    qt = np.full((B, 2), n_terms, np.int32)
    qt[:, 0] = 0
    qw = np.zeros((B, 2), np.float32)
    qw[:, 0] = np.linspace(0.5, 2.0, B, dtype=np.float32)
    os_, oi = oracle(d, t, w, n_docs, n_terms, qt, qw, k)
    assert all(len(np.unique(row)) == k for row in os_)  # genuinely tie-free
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, layout[0] * layout[1], device="cpu")
    kernels = dict(daat_use_kernels=True, daat_fused_chunk=True) if mode == "fused" else {}
    serve, stack = pod_step(pod_mesh(*layout), shards, dps, n_docs, k, rho_per_shard=0,
                            max_segs_per_term=0, engine="daat", daat_est_blocks=2,
                            daat_block_budget=2, max_bm_per_term=max(s.max_bm for s in shards),
                            **kernels)
    ss, si = serve(stack, qt, qw)
    np.testing.assert_allclose(ss.numpy(), os_, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(si.numpy(), oi)


@pytest.mark.parametrize("layout", [(1, 1), (2, 1), (3, 1), (2, 2)])
def test_pod_merge_tie_order_all_equal_scores(layout):
    """Every doc scores 1.0, so the whole top-k is tie-broken: the pod merge
    gives the oracle's ascending ids, bit for bit, at 1, 2, 3 and 4 ranks."""
    n_docs, n_terms, k, B = 17, 4, 10, 6
    d = np.arange(n_docs, dtype=np.int32)
    t = np.zeros(n_docs, dtype=np.int32)
    w = np.ones(n_docs, dtype=np.float32)
    qt = np.full((B, 2), n_terms, np.int32)
    qt[:, 0] = 0
    qw = np.zeros((B, 2), np.float32)
    qw[:, 0] = 1.0
    os_, oi = oracle(d, t, w, n_docs, n_terms, qt, qw, k)
    np.testing.assert_array_equal(oi, np.tile(np.arange(k, dtype=np.int32), (B, 1)))
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, layout[0] * layout[1], device="cpu")
    serve, stack = pod_step(pod_mesh(*layout), shards, dps, n_docs, k)
    ss, si = serve(stack, qt, qw)
    np.testing.assert_array_equal(ss.numpy(), os_)
    np.testing.assert_array_equal(si.numpy(), oi)


def test_pod_bucketed_routing_and_statics():
    d, t, w, n_docs, n_terms = coo(seed=2)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 1, device="cpu")
    stack = stack_indexes(shards)
    k = 5
    serve, in_specs, out_specs = make_bucketed_serve_step(
        pod_mesh(1, 1), lq_buckets=(4, 8), n_terms=n_terms, k=k,
        rho_per_shard=int(stack.doc_ids.shape[1]), max_segs_per_term=stack.max_segs,
        docs_per_shard=dps, n_docs_total=n_docs,
    )
    st = serve.statics
    assert st["pod_axes"] == ("pod", "model")  # the merge spans the whole mesh
    assert st["pod_hosts"] == 1 and st["pod_model_ranks"] == 1
    assert st["merge_fanin"] == 1 * 1 * k
    assert serve.buckets == (4, 8) and serve.inner.statics is st
    assert in_specs[0]["doc_ids"] == (("pod", "model"),) and out_specs[0] == (("pod",), None)
    rng = np.random.default_rng(3)
    qt = rng.integers(0, n_terms, (4, 3)).astype(np.int32)
    qw = rng.uniform(0.1, 2.0, (4, 3)).astype(np.float32)
    os_, oi = oracle(d, t, w, n_docs, n_terms, qt, qw, k)
    ss, si = serve(stack, qt, qw)
    np.testing.assert_allclose(ss.numpy(), os_, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(si.numpy(), oi)
    # a sharded-step mesh routes to the sharded step, with no pod keys
    plain, _, _ = make_bucketed_serve_step(
        cpu_mesh(), lq_buckets=(4, 8), n_terms=n_terms, k=k,
        rho_per_shard=int(stack.doc_ids.shape[1]), max_segs_per_term=stack.max_segs,
        docs_per_shard=dps, n_docs_total=n_docs,
    )
    assert "pod_axes" not in plain.statics
    np.testing.assert_array_equal(plain(stack, qt, qw)[1].numpy(), oi)


@pytest.mark.parametrize("k", [8, 36])
def test_pod_live_masked_at_four_ranks_equals_the_masked_oracle(k):
    """Each rank's shards meet their own tombstone rows at (2, 2). At k = 36
    the answer runs past the 40-doc corpus's live docs into ``-inf``: the
    dead docs come in ascending id, as the oracle's, ahead of the pad
    sentinels (the oracle's pad ids), on every rank."""
    rng = np.random.default_rng(12)
    d, t, w, n_docs, n_terms = coo(seed=12, n_docs=40, n_terms=16, nnz=260)
    live_full = (rng.random(n_docs) < 0.7).astype(np.int32)
    qt, qw = queries(13, n_terms, B=4, lq=5)
    os_, oi = oracle(d, t, w, n_docs, n_terms, qt, qw, k, live_full=live_full)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 4, device="cpu")
    serve, stack = pod_step(pod_mesh(2, 2), shards, dps, n_docs, k, live_masked=True)
    live = shard_live_stack(live_full, n_shards=4, docs_per_shard=dps,
                            n_docs_pad=int(stack.doc_n_terms.shape[1]))
    ss, si = serve(stack, qt, qw, live_stack=live)
    fin = np.isfinite(os_)
    assert (~fin).any() == (k > live_full.sum())
    np.testing.assert_array_equal(si.numpy(), np.where(oi >= n_docs, I32_MAX, oi))
    np.testing.assert_allclose(ss.numpy(), os_, rtol=1e-6, atol=1e-6)
    assert live_full[si.numpy()[fin]].all()


# ---------------------------------------------------------------------------
# (e) the host side
# ---------------------------------------------------------------------------


def both_servers(seed, n_shards=1, **cfg):
    d, t, w, n_docs, n_terms = coo(seed=seed)
    ref_shards, dps = ref_shard_corpus(d, t, w, n_docs, n_terms, n_shards)
    shards, _ = shard_corpus(d, t, w, n_docs, n_terms, n_shards, device="cpu")
    ref = RefPodServer(ref_pod_mesh(), ref_stack(ref_shards), RefConfig(**cfg),
                       docs_per_shard=dps, n_docs_total=n_docs)
    got = PodServer(pod_mesh(1, 1), stack_indexes(shards), ServingConfig(**cfg),
                    docs_per_shard=dps, n_docs_total=n_docs)
    return ref, got, dps


def test_pod_server_rho_ladder_is_per_shard():
    ref, got, _ = both_servers(4, n_shards=2, k=5, rho_ladder=(10, 10**9), lq_buckets=(4,))
    exact = int(got.index.doc_ids.shape[1])
    assert got.rho_ladder == ref.rho_ladder == (10, exact)
    assert got.rho_ladder[-1] > got.index.n_postings  # which would be the shard count


def test_pod_server_executable_key_embeds_pod_identity():
    ref, got, dps = both_servers(6, k=5, rho_ladder=(10**9,), lq_buckets=(4,))
    key = got.executable_key(4, 2, got.rho_ladder[-1])
    assert key == ref.executable_key(4, 2, ref.rho_ladder[-1])
    assert key[0] == "pod" and key[1] == 1 and key[3] == dps
    other = PodServer(pod_mesh(1, 1), got.index, got.cfg, docs_per_shard=dps + 1,
                      n_docs_total=got.n_docs_total)
    assert other.executable_key(4, 2, other.rho_ladder[-1]) != key
    # the lifecycle is in the key, the generation is not
    live = np.ones((1, got.index.doc_n_terms.shape[1]), np.int32)
    got.set_lifecycle(live_stack=live)
    ref.set_lifecycle(live_stack=live)
    masked = got.executable_key(4, 2, got.rho_ladder[-1])
    assert masked != key and masked == ref.executable_key(4, 2, ref.rho_ladder[-1])
    got.set_lifecycle(live_stack=live, generation=3)
    assert got.generation == 3 and got.executable_key(4, 2, got.rho_ladder[-1]) == masked


def fronts(layout, n_shards=None, **queue_kwargs):
    """The port's front end (and at (1, 1) the reference's) over the
    reference's front-end corpus."""
    d, t, w, n_docs, n_terms = coo(seed=5, n_docs=30, n_terms=16, nnz=200)
    n_shards = n_shards or layout[0] * layout[1]
    cfg = dict(k=5, rho_ladder=(10**9,), lq_buckets=(4, 8), batch_size=4)
    queue_kwargs.setdefault("batch_shapes", (2, 4))
    queue_kwargs.setdefault("max_wait_s", 0.05)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, n_shards, device="cpu")
    got = PodFrontEnd(pod_mesh(*layout), stack_indexes(shards), ServingConfig(**cfg),
                      docs_per_shard=dps, n_docs_total=n_docs, clock=SimulatedClock(),
                      queue_kwargs=dict(queue_kwargs))
    ref = None
    if layout == (1, 1):
        ref_shards, _ = ref_shard_corpus(d, t, w, n_docs, n_terms, n_shards)
        ref = RefFrontEnd(ref_pod_mesh(), ref_stack(ref_shards), RefConfig(**cfg),
                          docs_per_shard=dps, n_docs_total=n_docs, clock=RefSimulatedClock(),
                          queue_kwargs=dict(queue_kwargs))
    return got, ref, (d, t, w, n_docs, n_terms)


def submit_all(front, n_terms, n_queries, seed):
    rng = np.random.default_rng(seed)
    queries_, owners = [], {h: [] for h in range(front.n_hosts)}
    for i in range(n_queries):
        lq = int(rng.integers(2, 5))
        qt = rng.choice(n_terms, lq, replace=False).astype(np.int32)
        qw = rng.uniform(0.2, 2.0, lq).astype(np.float32)
        queries_.append((qt, qw))
        host = i % front.n_hosts
        owners[host].append(i)
        front.submit(host, qt, qw, deadline_ms=50.0)
    return queries_, owners


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
def test_pod_front_end_end_to_end(layout):
    """Per-host admission queues over one mesh: every completion equals a
    direct call of the pod step and the unsharded oracle, whichever host
    admitted it; at (1, 1) also the reference front end's completion."""
    got, ref, (d, t, w, n_docs, n_terms) = fronts(layout)
    queries_, owners = submit_all(got, n_terms, 6, seed=11)
    if ref is not None:
        submit_all(ref, n_terms, 6, seed=11)
    comps = got.drain()
    assert len(comps) == 6 and got.pending() == 0
    want = {(h, c.rid): c for h, c in ref.drain()} if ref is not None else None
    for host, c in comps:
        qt, qw = queries_[owners[host][c.rid]]
        _, oi = oracle(d, t, w, n_docs, n_terms, qt[None], qw[None], 5)
        np.testing.assert_array_equal(c.doc_ids, oi[0])
        srv = got.servers[host]
        direct = srv._pod_dispatch(qt[None], qw[None], srv.rho_ladder[-1])
        np.testing.assert_array_equal(c.doc_ids, direct.doc_ids[0].numpy())
        np.testing.assert_array_equal(c.scores, direct.scores[0].numpy())
        if want is not None:
            r = want[(host, c.rid)]
            np.testing.assert_array_equal(c.doc_ids, r.doc_ids)
            np.testing.assert_allclose(c.scores, r.scores, rtol=1e-6, atol=1e-6)
            assert (c.bucket, c.batch_shape, c.rho) == (r.bucket, r.batch_shape, r.rho)


def test_pod_front_end_counters_equal_the_references():
    got, ref, _ = fronts((1, 1))
    for front in (got, ref):
        rng = np.random.default_rng(13)
        for _ in range(4):
            qt = rng.choice(16, 3, replace=False).astype(np.int32)
            front.submit(0, qt, rng.uniform(0.2, 2.0, 3).astype(np.float32), 50.0)
        front.drain()
    reg = got.export_counters()
    text = reg.render()
    assert text == ref.export_counters().render()
    d = reg.as_dict()
    for fam in ("repro_queue_submitted_total", "repro_pod_dispatch_total",
                "repro_pod_merge_fanin"):
        assert fam in d, sorted(d)
    assert 'repro_queue_submitted_total{host="0"} 4' in text
    fanin = [s["value"] for s in d["repro_pod_merge_fanin"]["samples"]]
    assert fanin and all(v == pod_hosts(got.mesh) * 1 * 5 for v in fanin)


def test_warmup_pod_calibrates_every_host():
    got, _, (_, _, _, _, n_terms) = fronts((2, 1))
    qt, qw = queries(17, n_terms, B=3, lq=4)
    warmup_pod(got, qt, qw, batch_sizes=(2, 4))
    for srv in got.servers:
        assert srv.service_calibrated(4, srv.rho_ladder[-1])
        assert srv.n_pod_dispatches  # its own dispatches


def _handles(seed=12, n_docs=40, n_terms=16):
    """The reference's and the port's handle over the reference's lifecycle
    corpus, both after the same deletes and adds."""
    from test_torch_sharded_daat import _live_coo

    d, t, w = _live_coo(seed, n_docs, n_terms)
    ref = RefHandle.from_corpus(d, t, w, n_docs, n_terms)
    got = IndexHandle.from_corpus(d, t, w, n_docs, n_terms, device="cpu")
    rng = np.random.default_rng(seed)
    for gid in (2, 9):
        ref.delete(gid)
        got.delete(gid)
    for _ in range(2):
        n = int(rng.integers(2, 5))
        terms = rng.choice(n_terms, n, replace=False).astype(np.int64)
        weights = rng.uniform(0.2, 4.0, n)
        assert ref.add(terms, weights) == got.add(terms, weights)
    return (d, t, w), ref, got, rng


def _assert_lifecycle(res, ref_res, handle_res):
    s, i = res.scores.numpy(), res.doc_ids.numpy()
    for want_s, want_i in ((np.asarray(ref_res.scores), np.asarray(ref_res.doc_ids)),
                           (handle_res.scores.numpy(), handle_res.doc_ids.numpy())):
        fin = np.isfinite(want_s)
        np.testing.assert_array_equal(np.isfinite(s), fin)
        np.testing.assert_array_equal(i[fin], want_i[fin])
        np.testing.assert_allclose(s[fin], want_s[fin], rtol=1e-6, atol=1e-6)
    assert not np.isin(i[np.isfinite(s)], [2, 9]).any()


def test_pod_server_lifecycle_and_swap_stack():
    """A (1, 1) pod host with a tombstone stack and a delta pool, then
    ``swap_stack`` to the compacted generation: equal to the reference's
    ``PodServer`` and to the port's ``IndexHandle``."""
    (d, t, w), ref_h, got_h, rng = _handles()
    qt = rng.integers(0, 16, (4, 5)).astype(np.int32)
    qw = rng.uniform(0.1, 2.0, (4, 5)).astype(np.float32)
    k = 6
    cfg = dict(k=k, rho_ladder=(10**9,), lq_buckets=(5,), batch_size=4)
    ref_shards, dps = ref_shard_corpus(d, t, w, 40, 16, 1)
    shards, _ = shard_corpus(d, t, w, 40, 16, 1, device="cpu")
    ref = RefPodServer(ref_pod_mesh(), ref_stack(ref_shards), RefConfig(**cfg),
                       docs_per_shard=dps, n_docs_total=40)
    got = PodServer(pod_mesh(1, 1), stack_indexes(shards), ServingConfig(**cfg),
                    docs_per_shard=dps, n_docs_total=40)
    for srv, h in ((ref, ref_h), (got, got_h)):
        n_pad = int(srv.index.doc_n_terms.shape[1])
        live = shard_live_stack(np.asarray(h.live_mask)[:40], n_shards=1, docs_per_shard=dps,
                                n_docs_pad=n_pad)
        srv.set_lifecycle(live_stack=live, delta=h.delta, delta_gids=h.delta_gids,
                          generation=h.generation)
    _assert_lifecycle(got.search_batch(qt, qw), ref.search_batch(jnp.asarray(qt), jnp.asarray(qw)),
                      got_h.saat_search(qt, qw, k=k))

    for h in (ref_h, got_h):
        h.compact()
    servers = ((ref, ref_h, ref_shard_corpus, ref_stack, {}),
               (got, got_h, shard_corpus, stack_indexes, dict(device="cpu")))
    for srv, h, shard, stack_fn, dev in servers:
        d2, t2, w2 = h.export_coo()
        shards2, dps2 = shard(d2, t2, w2, h.n_docs, 16, 1, quant_max_weight=h.quant_max_weight,
                              **dev)
        stack2 = stack_fn(shards2)
        live2 = shard_live_stack(np.asarray(h.live_mask)[: h.n_docs], n_shards=1,
                                 docs_per_shard=dps2, n_docs_pad=int(stack2.doc_n_terms.shape[1]))
        srv.swap_stack(stack2, live_stack=live2, generation=h.generation, docs_per_shard=dps2,
                       n_docs_total=h.n_docs)
        assert srv.generation == h.generation and srv.docs_per_shard == dps2
    assert got.rho_ladder == ref.rho_ladder
    _assert_lifecycle(got.search_batch(qt, qw), ref.search_batch(jnp.asarray(qt), jnp.asarray(qw)),
                      got_h.saat_search(qt, qw, k=k))
    assert got.executable_key(5, 4) == ref.executable_key(5, 4)


def test_pod_server_rejects_a_host_outside_the_pod():
    d, t, w, n_docs, n_terms = coo(seed=6)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 2, device="cpu")
    with pytest.raises(ValueError, match="outside the pod's 2 hosts"):
        PodServer(pod_mesh(2, 1), stack_indexes(shards), ServingConfig(k=5),
                  docs_per_shard=dps, host=2)
    with pytest.raises(ValueError, match="set .or cleared. together"):
        PodServer(pod_mesh(2, 1), stack_indexes(shards), ServingConfig(k=5),
                  docs_per_shard=dps).set_lifecycle(delta_gids=torch.zeros(1))
