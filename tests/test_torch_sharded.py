"""The port's doc-sharded serve step against the JAX reference's: SAAT.

* ``shard_corpus`` and ``stack_indexes``: every field of the port's stack
  array-equal to the reference's, and the metadata equal;
  ``abstract_stacked_index`` the reference's shapes and dtypes on the
  ``meta`` device; ``shard_live_stack`` equal;
* ``make_sharded_serve_step`` on the port's in-process (1, 1) mesh against
  the reference's on ``jax.make_mesh((1, 1), ("data", "model"))`` (what the
  reference's own tests run on one CPU device), at 1 to 4 shards of the
  reference's ragged 37-doc corpus, in each SAAT mode (the port's
  ``"sort"``, ``"scatter"``, ``"kernel"`` and fused beside the reference's
  ``"sort"``, ``"jnp"``, ``"pallas"`` and fused, Pallas in interpret mode),
  exact and under a per-shard budget; the pad-alias corpus (k past every
  shard's live docs) and an empty shard: ids equal, scores within rtol
  1e-6;
* the merges alone: ``canonical_topk_merge`` equal to the reference's body
  after its gather (a stable id sort, then ``tiled_topk`` a tile a rank)
  and ``sharded_topk_merge`` to ``jax.lax.top_k`` over the rank-major
  concatenation, for 1 to 8 ranks of pools holding ``-inf`` rows,
  ``INT32_MAX`` sentinels and ties;
* the guards the reference raises on, with its messages.

The DAAT and live-masked cases are in ``test_torch_sharded_daat.py``, the
pod layouts and the host side in ``test_torch_pod.py``, the collective path
in ``test_torch_collective.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.saat import max_segments_per_term as ref_max_segs
from repro.core.topk import tiled_topk as ref_tiled_topk
from repro.serving import abstract_stacked_index as ref_abstract
from repro.serving import make_sharded_serve_step as ref_step
from repro.serving import shard_corpus as ref_shard_corpus
from repro.serving import shard_live_stack as ref_live_stack
from repro.serving import stack_indexes as ref_stack
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, canonical_topk_merge, sharded_topk_merge
from repro_torch.distributed import Mesh, make_mesh, mesh_axes
from repro_torch.serving import (
    abstract_stacked_index,
    make_pod_serve_step,
    make_sharded_serve_step,
    rank_block,
    shard_corpus,
    shard_live_stack,
    stack_indexes,
)

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-6
I32_MAX = np.iinfo(np.int32).max
# port mode -> (port step keywords, reference step keywords)
SAAT_MODES = {
    "sort": (dict(), dict()),
    "scatter": (dict(scatter_impl="scatter"), dict(scatter_impl="jnp")),
    "kernel": (dict(scatter_impl="kernel"), dict(scatter_impl="pallas")),
    "fused": (dict(fused_topk=True), dict(fused_topk=True)),
}


def coo(seed=0, n_docs=37, n_terms=24, nnz=300):
    """The reference's random deduplicated COO corpus (``tests/test_pod.py``):
    ragged against most shard counts."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, n_docs, nnz).astype(np.int32)
    t = rng.integers(0, n_terms, nnz).astype(np.int32)
    w = rng.uniform(0.1, 5.0, nnz).astype(np.float32)
    _, ix = np.unique(d.astype(np.int64) * n_terms + t, return_index=True)
    return d[ix], t[ix], w[ix], n_docs, n_terms


def queries(seed, n_terms, B=8, lq=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_terms, (B, lq)).astype(np.int32),
            rng.uniform(0.1, 2.0, (B, lq)).astype(np.float32))


def cpu_mesh(shape=(1, 1), names=("data", "model")) -> Mesh:
    return make_mesh(shape, names, device="cpu")


def both_stacks(d, t, w, n_docs, n_terms, n_shards, **build):
    """The reference's shards and stack, the port's, and docs_per_shard;
    the two stacks array-equal."""
    ref_shards, dps = ref_shard_corpus(d, t, w, n_docs, n_terms, n_shards, **build)
    shards, dps2 = shard_corpus(d, t, w, n_docs, n_terms, n_shards, device="cpu", **build)
    assert dps == dps2
    ref, got = ref_stack(ref_shards), stack_indexes(shards)
    for f in ARRAY_FIELDS:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype and np.array_equal(have, want), f
    for f in META_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    return ref_shards, ref, got, dps


def assert_step_parity(ref_stack_, stack, qt, qw, port_kw, ref_kw, live=None, **common):
    """The port's (1, 1) sharded step against the reference's: ids equal,
    scores within RTOL. Returns the port's answer."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rserve, _, _ = ref_step(mesh, **common, **ref_kw)
    extra = {} if live is None else {"live_stack": jnp.asarray(live)}
    with mesh:
        rs, ri = rserve(ref_stack_, jnp.asarray(qt), jnp.asarray(qw), **extra)
    serve, _, _ = make_sharded_serve_step(cpu_mesh(), **common, **port_kw)
    extra = {} if live is None else {"live_stack": live}
    s, i = serve(stack, qt, qw, **extra)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=RTOL, atol=ATOL)
    return s.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards,block_size", [(1, 128), (3, 128), (4, 16), (2, 64)])
def test_stack_equals_the_references(n_shards, block_size):
    d, t, w, n_docs, n_terms = coo(seed=1)
    both_stacks(d, t, w, n_docs, n_terms, n_shards, block_size=block_size)


def test_abstract_stacked_index_shapes_and_dtypes():
    kw = dict(n_shards=4, docs_per_shard=69_077, n_terms=3000, postings_per_shard=1_000_064,
              segments_per_shard=70_000, bm_cells_per_shard=200_000, max_doc_terms=650)
    ref, got = ref_abstract(**kw), abstract_stacked_index(**kw)
    for f in ARRAY_FIELDS:
        t, r = getattr(got, f), getattr(ref, f)
        assert t.device.type == "meta", f
        assert tuple(t.shape) == tuple(r.shape), f
        assert str(t.dtype).split(".")[-1] == str(r.dtype), f
    for f in META_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f


def test_shard_live_stack_equals_the_references():
    rng = np.random.default_rng(2)
    live = (rng.random(37) < 0.7).astype(np.int32)
    kw = dict(n_shards=3, docs_per_shard=13, n_docs_pad=16)
    np.testing.assert_array_equal(shard_live_stack(live, **kw), ref_live_stack(live, **kw))
    with pytest.raises(ValueError, match="smaller than docs_per_shard"):
        shard_live_stack(live, n_shards=3, docs_per_shard=13, n_docs_pad=12)


def test_rank_block_gives_each_rank_its_rows():
    mesh = cpu_mesh((2, 2), ("pod", "model"))
    x = np.arange(8 * 3).reshape(8, 3)
    shard_axes = mesh_axes(mesh).all
    rows = [rank_block(x, (shard_axes,), mesh, r) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(rows), x)  # pod-major flat order
    hosts = [rank_block(x, (("pod",), None), mesh, r) for r in range(4)]
    np.testing.assert_array_equal(hosts[0], hosts[1])  # both model ranks of host 0
    np.testing.assert_array_equal(hosts[2], x[4:])
    assert rank_block(x, (), mesh, 3) is x


# ---------------------------------------------------------------------------
# (a) the sharded step against the reference's at (1, 1): SAAT
# ---------------------------------------------------------------------------


SAAT_CASES = [
    ("sort", "exact", 1), ("sort", "exact", 2), ("sort", "exact", 3), ("sort", "exact", 4),
    ("sort", "budget", 2), ("scatter", "exact", 3), ("kernel", "budget", 2),
    ("fused", "exact", 4), ("fused", "budget", 3),
]


@pytest.mark.parametrize("mode,budget,n_shards", SAAT_CASES)
def test_sharded_saat_equals_the_references(mode, budget, n_shards):
    d, t, w, n_docs, n_terms = coo()
    ref_shards, rstack, stack, dps = both_stacks(d, t, w, n_docs, n_terms, n_shards)
    qt, qw = queries(7, n_terms)
    rho = int(rstack.doc_ids.shape[1]) if budget == "exact" else 50
    common = dict(k=10, rho_per_shard=rho, docs_per_shard=dps, n_docs_total=n_docs,
                  max_segs_per_term=max(ref_max_segs(s) for s in ref_shards))
    assert_step_parity(rstack, stack, qt, qw, *SAAT_MODES[mode], **common)


def test_sharded_pad_docs_never_alias_real_ids():
    """k past every shard's live docs (3 shards of 2 over 5 docs, the last
    short): the port gives the reference's answer, the overflow slots
    ``(-inf, INT32_MAX)`` sentinels and no id twice."""
    d = np.arange(5, dtype=np.int64)
    w = 5.0 - np.arange(5, dtype=np.float64)
    n_docs, n_terms, k = 5, 6, 8
    ref_shards, rstack, stack, dps = both_stacks(d, d.copy(), w, n_docs, n_terms, 3)
    qt = np.arange(5, dtype=np.int32)[None, :]
    qw = np.ones((1, 5), np.float32)
    common = dict(k=k, rho_per_shard=max(s.n_postings for s in ref_shards), docs_per_shard=dps,
                  n_docs_total=n_docs, max_segs_per_term=max(ref_max_segs(s) for s in ref_shards))
    s, i = assert_step_parity(rstack, stack, qt, qw, {}, {}, **common)
    assert i[0, :n_docs].tolist() == [0, 1, 2, 3, 4]
    assert np.all(i[0, n_docs:] == I32_MAX) and np.all(np.isneginf(s[0, n_docs:]))


def test_sharded_empty_shard_serves():
    """Postings only in docs 0 and 1; 2 shards of 2, so shard 1 is empty."""
    d = np.array([0, 0, 1]); t = np.array([0, 1, 2]); w = np.array([2.0, 1.0, 3.0])
    n_docs, n_terms = 4, 5
    ref_shards, rstack, stack, dps = both_stacks(d, t, w, n_docs, n_terms, 2)
    assert ref_shards[1].max_segs == 0  # precondition: the second shard IS empty
    qt = np.array([[0, 2]], np.int32)
    qw = np.ones((1, 2), np.float32)
    common = dict(k=n_docs, rho_per_shard=max(s.n_postings for s in ref_shards),
                  docs_per_shard=dps, n_docs_total=n_docs,
                  max_segs_per_term=max(1, max(ref_max_segs(s) for s in ref_shards)))
    _, i = assert_step_parity(rstack, stack, qt, qw, {}, {}, **common)
    assert i[0, :2].tolist() == [1, 0] and set(i[0].tolist()) == set(range(n_docs))


def test_data_axis_splits_the_batch():
    """At (2, 1) the in-process step answers each data rank's half of the
    batch: the same answer as (1, 1)."""
    d, t, w, n_docs, n_terms = coo(seed=3)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 2, device="cpu")
    stack = stack_indexes(shards)
    qt, qw = queries(9, n_terms)
    kw = dict(k=10, rho_per_shard=int(stack.doc_ids.shape[1]), docs_per_shard=dps,
              n_docs_total=n_docs, max_segs_per_term=stack.max_segs)
    want = make_sharded_serve_step(cpu_mesh(), **kw)[0](stack, qt, qw)
    got = make_sharded_serve_step(cpu_mesh((2, 1)), **kw)[0](stack, qt, qw)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    with pytest.raises(ValueError, match="equal blocks"):
        make_sharded_serve_step(cpu_mesh((3, 1)), **kw)[0](stack, qt, qw)


# ---------------------------------------------------------------------------
# (c) the merges alone
# ---------------------------------------------------------------------------


def rank_pools(n_ranks, seed, B=5, k=6):
    """Per-rank ``[B, k]`` pools, each rank a contiguous id range sorted
    descending by score, with integer scores full of ties, ``-inf`` rows and
    ``(-inf, INT32_MAX)`` sentinels at the tail of some rows."""
    rng = np.random.default_rng(seed)
    pools = []
    for r in range(n_ranks):
        s = rng.integers(0, 4, (B, k)).astype(np.float32)
        ids = np.stack([rng.choice(np.arange(r * 20, r * 20 + 20), k, replace=False)
                        for _ in range(B)]).astype(np.int32)
        n_pad = rng.integers(0, k + 1, B)
        for b in range(B):
            if n_pad[b]:
                s[b, k - n_pad[b]:] = -np.inf
                ids[b, k - n_pad[b]:] = I32_MAX
        if rng.random() < 0.5:
            s[rng.integers(B)] = -np.inf  # a row of real -inf documents
        order = np.argsort(-s, axis=-1, kind="stable")
        pools.append((np.take_along_axis(s, order, -1), np.take_along_axis(ids, order, -1)))
    return pools


def ref_canonical_body(gs, gi, k, n_ranks):
    """``repro.core.topk.canonical_topk_merge`` after its all-gather."""
    order = jnp.argsort(gi, axis=-1)
    gs = jnp.take_along_axis(gs, order, axis=-1)
    gi = jnp.take_along_axis(gi, order, axis=-1)
    ms, mi = ref_tiled_topk(gs, k, num_tiles=n_ranks)
    return np.asarray(ms), np.asarray(jnp.take_along_axis(gi, mi, axis=-1))


@pytest.mark.parametrize("n_ranks", range(1, 9))
@pytest.mark.parametrize("k", [1, 6, 10])
def test_merges_equal_the_references(n_ranks, k):
    pools = rank_pools(n_ranks, seed=100 + n_ranks)
    gs = jnp.asarray(np.concatenate([p[0] for p in pools], -1))
    gi = jnp.asarray(np.concatenate([p[1] for p in pools], -1))
    ts = [torch.from_numpy(p[0]) for p in pools]
    ti = [torch.from_numpy(p[1]) for p in pools]
    k_eff = min(k, gs.shape[-1])

    s, i = canonical_topk_merge(ts, ti, k_eff)
    ws, wi = ref_canonical_body(gs, gi, k_eff, n_ranks)
    np.testing.assert_array_equal(s.numpy(), ws)
    np.testing.assert_array_equal(i.numpy(), wi)

    s, i = sharded_topk_merge(ts, ti, k_eff)
    ws, wpos = jax.lax.top_k(gs, k_eff)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(i.numpy(), np.asarray(jnp.take_along_axis(gi, wpos, -1)))


def test_canonical_merge_puts_sentinels_behind_real_neg_inf_docs():
    """A sentinel on rank 0 and a real ``-inf`` doc on rank 1: the canonical
    merge gives the doc, the position-order merge the sentinel."""
    s0 = torch.tensor([[3.0, float("-inf")]])
    i0 = torch.tensor([[4, I32_MAX]], dtype=torch.int32)
    s1 = torch.tensor([[float("-inf"), float("-inf")]])
    i1 = torch.tensor([[40, 41]], dtype=torch.int32)
    _, ci = canonical_topk_merge([s0, s1], [i0, i1], 2)
    _, si = sharded_topk_merge([s0, s1], [i0, i1], 2)
    assert ci.tolist() == [[4, 40]] and si.tolist() == [[4, I32_MAX]]


# ---------------------------------------------------------------------------
# (f) guards the reference raises on
# ---------------------------------------------------------------------------


STEP = dict(k=5, rho_per_shard=0, max_segs_per_term=0, docs_per_shard=100)


@pytest.mark.parametrize("build", [make_sharded_serve_step, make_pod_serve_step])
def test_guards_raise_as_the_reference(build):
    mesh = cpu_mesh((1, 1), ("pod", "model"))
    with pytest.raises(ValueError, match="daat_trips_per_launch > 1"):
        build(mesh, engine="daat", max_bm_per_term=4, daat_use_kernels=True,
              daat_trips_per_launch=3, **STEP)
    with pytest.raises(ValueError, match="daat_fused_chunk fuses"):
        build(mesh, engine="daat", max_bm_per_term=4, daat_fused_chunk=True, **STEP)
    with pytest.raises(ValueError, match="must be >= 1"):
        build(mesh, engine="daat", max_bm_per_term=4, daat_use_kernels=True,
              daat_fused_chunk=True, daat_trips_per_launch=0, **STEP)
    with pytest.raises(ValueError, match="static max_bm_per_term"):
        build(mesh, engine="daat", **STEP)
    with pytest.raises(ValueError, match="unknown engine"):
        build(mesh, engine="taat", **STEP)


@pytest.mark.parametrize("build", [make_sharded_serve_step, make_pod_serve_step])
def test_live_stack_guards(build):
    d, t, w, n_docs, n_terms = coo(seed=4)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 1, device="cpu")
    stack = stack_indexes(shards)
    qt, qw = queries(5, n_terms, B=2)
    live = np.ones((1, stack.doc_n_terms.shape[1]), np.int32)
    kw = dict(k=5, rho_per_shard=int(stack.doc_ids.shape[1]), max_segs_per_term=stack.max_segs,
              docs_per_shard=dps, n_docs_total=n_docs)
    mesh = cpu_mesh((1, 1), ("pod", "model"))
    unmasked, _, _ = build(mesh, **kw)
    with pytest.raises(ValueError, match="built without live_masked=True"):
        unmasked(stack, qt, qw, live_stack=live)
    masked, in_specs, _ = build(mesh, live_masked=True, **kw)
    assert len(in_specs) == 4 and masked.statics["live_masked"]
    with pytest.raises(ValueError, match="pass the per-shard live_stack"):
        masked(stack, qt, qw)
    masked(stack, qt, qw, live_stack=live)  # and with it, it serves


def test_pod_step_needs_pod_and_model_axes():
    with pytest.raises(ValueError, match="needs a 'pod' mesh axis"):
        make_pod_serve_step(cpu_mesh(), **STEP)
    with pytest.raises(ValueError, match="needs a 'model' mesh axis"):
        make_pod_serve_step(cpu_mesh((1, 1), ("pod", "data")), **STEP)


def test_a_stack_off_the_mesh_device_raises():
    d, t, w, n_docs, n_terms = coo(seed=4)
    shards, dps = shard_corpus(d, t, w, n_docs, n_terms, 1, device="cpu")
    stack = stack_indexes(shards)
    meta_mesh = Mesh(("data", "model"), (1, 1), torch.device("meta"))
    serve, _, _ = make_sharded_serve_step(meta_mesh, k=5, rho_per_shard=10,
                                          max_segs_per_term=stack.max_segs, docs_per_shard=dps)
    with pytest.raises(ValueError, match="index_stack.to"):
        serve(stack, *queries(5, n_terms, B=2))


def test_mesh_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("pod", [False, True])
def test_statics_and_specs_have_the_references_keys(pod):
    from repro.serving import make_pod_serve_step as ref_pod_step

    kw = dict(k=5, rho_per_shard=10, max_segs_per_term=2, docs_per_shard=20, live_masked=True)
    names = ("pod", "model") if pod else ("data", "model")
    ref_mesh = jax.make_mesh((1, 1), names)
    ref_serve, ref_in, ref_out = (ref_pod_step if pod else ref_step)(ref_mesh, **kw)
    serve, in_specs, out_specs = (make_pod_serve_step if pod else make_sharded_serve_step)(
        cpu_mesh((1, 1), names), **kw)
    assert list(serve.statics) == list(ref_serve.statics)
    assert {k: v for k, v in serve.statics.items() if k != "pod_axes"} == {
        k: v for k, v in ref_serve.statics.items() if k != "pod_axes"}
    if pod:
        assert serve.statics["pod_axes"] == tuple(ref_serve.statics["pod_axes"])
    assert len(in_specs) == len(ref_in) == 4 and len(out_specs) == len(ref_out) == 2
    assert set(in_specs[0]) == set(ref_in[0])
