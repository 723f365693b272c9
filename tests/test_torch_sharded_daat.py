"""The port's doc-sharded serve step against the JAX reference's: DAAT and
the live-masked (tombstone) variant.

On the port's in-process (1, 1) mesh and the reference's
``jax.make_mesh((1, 1), ("data", "model"))``, at 1 to 4 shards:

* block-max DAAT over the reference's ``bm25`` fixture (400 docs, the
  reference's own test settings: ``est_blocks`` 2, ``block_budget`` 2) in
  the plain mode and the kernel modes (split, fused, 3 trips a launch; the
  reference's Pallas kernels in interpret mode), and at block size 64 with
  a non-unit quantization scale;
* ``live_masked=True`` with a ``shard_live_stack`` stack, SAAT (sort and
  fused) and DAAT, held to the reference's step and to the unsharded
  masked oracle.

Bar: ids equal, scores within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import build_impact_index as ref_build
from repro.core import saat as ref_saat
from repro.core.saat import max_segments_per_term as ref_max_segs
from repro.serving import shard_live_stack as ref_live_stack
from repro_torch.serving import shard_live_stack
from test_torch_sharded import assert_step_parity, both_stacks

pytestmark = pytest.mark.torch_port

DAAT = dict(rho_per_shard=0, max_segs_per_term=0, engine="daat", daat_est_blocks=2,
            daat_block_budget=2, k=10)
DAAT_MODES = {
    "plain": dict(),
    "split": dict(daat_use_kernels=True),
    "fused": dict(daat_use_kernels=True, daat_fused_chunk=True),
    "multi3": dict(daat_use_kernels=True, daat_fused_chunk=True, daat_trips_per_launch=3),
}
DAAT_CASES = [("plain", 1, 128), ("plain", 2, 128), ("split", 2, 128), ("fused", 3, 128),
              ("multi3", 4, 128), ("plain", 2, 64)]


@pytest.mark.parametrize("mode,n_shards,block_size", DAAT_CASES)
def test_sharded_daat_equals_the_references(tiny_corpus, bm25_collection, bm25_queries,
                                            mode, n_shards, block_size):
    enc = bm25_collection
    ref_shards, rstack, stack, dps = both_stacks(
        enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms, n_shards,
        block_size=block_size,
    )
    if block_size != 128:
        assert stack.block_size == block_size and stack.scale != 1.0
    qt, qw = (np.asarray(a) for a in bm25_queries)
    kw = dict(DAAT_MODES[mode])
    assert_step_parity(rstack, stack, qt, qw, kw, kw, docs_per_shard=dps,
                       n_docs_total=tiny_corpus.n_docs, max_bm_per_term=rstack.max_bm, **DAAT)


def _live_coo(seed=10, n_docs=80, n_terms=24, nnz=420):
    """The reference's lifecycle corpus (``tests/test_mutation.py``)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, n_docs, nnz).astype(np.int64)
    t = rng.integers(0, n_terms, nnz).astype(np.int64)
    w = rng.uniform(0.1, 5.0, nnz)
    _, ix = np.unique(d * n_terms + t, return_index=True)
    return d[ix], t[ix], w[ix]


LIVE_CASES = [("sort", 2), ("fused", 4), ("daat", 2), ("daat_fused", 3)]


@pytest.mark.parametrize("mode,n_shards", LIVE_CASES)
def test_sharded_live_masked_equals_the_references(mode, n_shards):
    rng = np.random.default_rng(10)
    n_docs, n_terms, k = 80, 24, 8
    d, t, w = _live_coo()
    dead = sorted(rng.choice(n_docs, 17, replace=False).tolist())
    live_full = np.ones(n_docs, np.int32)
    live_full[dead] = 0
    ref_shards, rstack, stack, dps = both_stacks(d, t, w, n_docs, n_terms, n_shards)
    lkw = dict(n_shards=n_shards, docs_per_shard=dps, n_docs_pad=int(stack.doc_n_terms.shape[1]))
    live = shard_live_stack(live_full, **lkw)
    np.testing.assert_array_equal(live, ref_live_stack(live_full, **lkw))
    qt = rng.integers(0, n_terms, (4, 5)).astype(np.int32)
    qw = rng.uniform(0.1, 2.0, (4, 5)).astype(np.float32)
    common = dict(k=k, docs_per_shard=dps, n_docs_total=n_docs, live_masked=True)
    if mode.startswith("daat"):
        kw = DAAT_MODES["fused" if mode == "daat_fused" else "plain"]
        common.update(rho_per_shard=0, max_segs_per_term=0, engine="daat", daat_est_blocks=2,
                      daat_block_budget=2, max_bm_per_term=rstack.max_bm)
    else:
        kw = dict(fused_topk=True) if mode == "fused" else {}
        common.update(rho_per_shard=max(s.n_postings for s in ref_shards),
                      max_segs_per_term=max(ref_max_segs(s) for s in ref_shards))
    s, i = assert_step_parity(rstack, stack, qt, qw, kw, kw, live=live, **common)

    # and the unsharded masked oracle, as the reference's own test holds it
    oracle = ref_build(d, t, w, n_docs, n_terms)
    lm = np.zeros(int(oracle.doc_n_terms.shape[0]), np.int32)
    lm[:n_docs] = live_full
    ex = ref_saat.saat_search(
        oracle, jnp.asarray(qt), jnp.asarray(qw), k=k, rho=ref_saat.exact_rho(oracle),
        max_segs_per_term=ref_saat.max_segments_per_term(oracle), live_mask=jnp.asarray(lm),
    )
    os_, oi = np.asarray(ex.scores), np.asarray(ex.doc_ids)
    fin = np.isfinite(os_)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_array_equal(i[fin], oi[fin])
    np.testing.assert_allclose(s[fin], os_[fin], rtol=1e-6, atol=1e-6)
    assert not np.isin(i[fin], dead).any()
