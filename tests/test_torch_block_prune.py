"""The port's dense block-prune kernel (B8) and its input builder against the
JAX reference.

* B8's plain version and its CPU wrappers (batched and B=1) against the
  reference's ``block_prune_batched`` / ``block_prune`` (Pallas, interpret
  mode) over the reference's ``CONTRACT.shape_grid``: ub within rtol 1e-5
  (the reference contracts on the matrix unit, in another order), masks
  equal, with every theta away from a tie with a bound;
* the port's ``_dense_blockmax_rows`` array-equal to the reference's on the
  conftest indexes;
* the dense bound, ``block_prune`` over those rows, bit-equal to the port's
  ``block_upper_bounds`` and to the CSR wrapper (``block_prune_csr``):
  every bound is summed slot by slot in all three.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_impact_index as ref_build
from repro.core import pad_queries as ref_pad_queries
from repro.core.daat import _dense_blockmax_rows as ref_dense_rows
from repro.kernels.block_prune.ops import CONTRACT
from repro.kernels.block_prune.ops import block_prune as ref_block_prune
from repro.kernels.block_prune.ops import block_prune_batched as ref_block_prune_batched
from repro_torch.core import ARRAY_FIELDS, META_FIELDS, block_upper_bounds, csr_blockmax_offsets
from repro_torch.core import index_from_numpy, max_blocks_per_term
from repro_torch.core.daat import _dense_blockmax_rows
from repro_torch.kernels.block_prune import block_prune, block_prune_batched
from repro_torch.kernels.block_prune.ref import block_prune_batched_ref
from repro_torch.kernels.block_prune_csr import block_prune_csr_batched

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5
CASES = {case.name: case.dims for case in CONTRACT.shape_grid}


def _inputs(dims, seed):
    """Block maxima with a fifth of the entries 0 (blocks a slot's term
    misses), a zero-weight slot, and per-query thetas at the midpoint of the
    widest gap between neighbouring bounds in the middle half of the row,
    so no bound ties with theta."""
    rng = np.random.default_rng(seed)
    lead = (dims["batch"],) if "batch" in dims else (1,)
    bm = rng.gamma(1.0, 1.0, lead + (dims["lq"], dims["nb"])).astype(np.float32)
    bm[rng.random(bm.shape) < 0.2] = 0.0
    qw = rng.gamma(1.0, 1.0, lead + (dims["lq"],)).astype(np.float32)
    if dims["lq"] > 2:
        qw[:, 2] = 0.0
    ub = np.einsum("bl,bln->bn", qw.astype(np.float64), bm.astype(np.float64))
    theta = np.empty(lead, np.float32)
    for b in range(lead[0]):
        vals = np.unique(ub[b])
        if len(vals) < 2:
            theta[b] = vals[0] - 1.0
            continue
        lo, hi = len(vals) // 4, max(len(vals) // 4 + 1, 3 * len(vals) // 4)
        i = lo + int(np.argmax(np.diff(vals)[lo:hi]))
        theta[b] = 0.5 * (vals[i] + vals[i + 1])
        gap = np.abs(ub[b] - theta[b]).min()
        assert gap > 1e-4 * max(1.0, abs(float(theta[b]))), "theta too close to a bound"
    return bm, qw, theta


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_prune_matches_reference_on_contract_grid(name):
    dims = CASES[name]
    bm, qw, theta = _inputs(dims, seed=sorted(CASES).index(name))
    t = (torch.as_tensor(bm), torch.as_tensor(qw), torch.as_tensor(theta))
    kw = dict(block_nb=dims["block_nb"], interpret=True)
    if "batch" in dims:
        want_ub, want_mask = ref_block_prune_batched(
            jnp.asarray(bm), jnp.asarray(qw), jnp.asarray(theta), **kw)
        got = [block_prune_batched_ref(*t), block_prune_batched(*t)]
    else:
        want_ub, want_mask = ref_block_prune(
            jnp.asarray(bm[0]), jnp.asarray(qw[0]), jnp.asarray(theta[0]), **kw)
        want_ub, want_mask = np.asarray(want_ub)[None], np.asarray(want_mask)[None]
        one = block_prune(t[0][0], t[1][0], float(theta[0]))
        got = [block_prune_batched_ref(*t), (one[0][None], one[1][None])]
    for ub, mask in got:
        assert ub.dtype == torch.float32 and mask.dtype == torch.bool
        np.testing.assert_allclose(ub.numpy(), np.asarray(want_ub), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def test_block_prune_b1_wrapper_equals_batched_rows():
    bm, qw, theta = _inputs(dict(batch=3, lq=6, nb=300), seed=9)
    ub, mask = block_prune_batched(torch.as_tensor(bm), torch.as_tensor(qw), torch.as_tensor(theta))
    for b in range(3):
        ub1, mask1 = block_prune(torch.as_tensor(bm[b]), torch.as_tensor(qw[b]), float(theta[b]))
        assert torch.equal(ub1, ub[b]) and torch.equal(mask1, mask[b])


@pytest.fixture(scope="module")
def indexes(tiny_corpus, bm25_collection, splade_collection, bm25_index):
    """name -> (reference index, port index, q_terms, q_weights); the query
    rows carry a duplicate term, a zero-weight slot and trailing pads."""
    enc = splade_collection
    splade = ref_build(enc.doc_idx, enc.term_idx, enc.weights, tiny_corpus.n_docs, enc.n_terms)
    out = {}
    for name, ref, coll in (("bm25", bm25_index, bm25_collection), ("spladev2", splade, enc)):
        max_q = max(len(t) for t in coll.query_terms)
        qt, qw = (np.array(a) for a in ref_pad_queries(coll.query_terms, coll.query_weights,
                                                       max_q, coll.n_terms))
        qt[:, 1] = qt[:, 0]
        qw[:, 2] = 0.0
        qt[3, max_q // 2:], qw[3, max_q // 2:] = coll.n_terms, 0.0
        arrays = {f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS}
        port = index_from_numpy(arrays, {f: getattr(ref, f) for f in META_FIELDS}, device="cpu")
        out[name] = (ref, port, qt, qw)
    return out


@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_dense_blockmax_rows_equal_reference(indexes, model):
    ref, port, qt, qw = indexes[model]
    mb = max_blocks_per_term(port)
    want = np.asarray(ref_dense_rows(ref, jnp.asarray(qt), jnp.asarray(qw), mb))
    got = _dense_blockmax_rows(port, torch.as_tensor(qt), torch.as_tensor(qw), mb)
    assert got.shape == (qt.shape[0], qt.shape[1], port.n_blocks)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("model", ["bm25", "spladev2"])
def test_dense_bound_bit_equal_to_csr_bound(indexes, model):
    """ub from the dense rows equals ``block_upper_bounds`` and the CSR
    kernel's wrapper bit for bit; the masks at the DAAT-like thetas agree."""
    _, port, qt, qw = indexes[model]
    mb = max_blocks_per_term(port)
    qt, qw = torch.as_tensor(qt), torch.as_tensor(qw)
    want = block_upper_bounds(port, qt, qw, mb)
    theta = torch.quantile(want, 0.9, dim=-1)
    dense = _dense_blockmax_rows(port, qt, qw, mb)
    ub, mask = block_prune_batched(dense, qw, theta)
    assert torch.equal(ub, want)
    base, cnt = csr_blockmax_offsets(port, qt, qw, mb)
    csr_ub, csr_mask = block_prune_csr_batched(port.bm_block, port.bm_weight, base, cnt, qw,
                                               theta, n_blocks=port.n_blocks, max_bm_per_term=mb)
    assert torch.equal(ub, csr_ub)
    assert torch.equal(mask, csr_mask)
