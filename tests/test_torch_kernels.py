"""The port's kernel wrappers (plain path on the CPU) against the reference's
Pallas kernels in interpret mode, at every shape of the reference's
``CONTRACT.shape_grid``, on the same numpy inputs.

Ids must be equal. Scores agree within rtol 1e-5 / atol 1e-5: the port adds
each doc's contributions one by one in doc-sorted order, the Pallas kernel
as a one-hot dot, which reassociates the sums (the reference's own Pallas
and jnp modes differ by up to 1e-4, ``tests/test_fused_topk.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.impact_scatter import ops as ref_scatter
from repro.kernels.impact_scatter_topk import ops as ref_fused
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops

pytestmark = pytest.mark.torch_port

RTOL = ATOL = 1e-5


def _inputs(dims, seed):
    rng = np.random.default_rng(seed)
    shape = (dims["batch"], dims["n_postings"]) if "batch" in dims else (dims["n_postings"],)
    docs = rng.integers(0, dims["n_docs"], shape).astype(np.int32)
    contribs = rng.gamma(2.0, 1.0, shape).astype(np.float32)
    live = (rng.random(dims["n_docs"]) < 0.8).astype(np.int32) if dims.get("live") else None
    return docs, contribs, live


@pytest.mark.parametrize("case", ref_scatter.CONTRACT.shape_grid, ids=lambda c: c.name)
def test_impact_scatter_contract_shapes(case):
    d = case.dims
    docs, contribs, _ = _inputs(d, seed=len(case.name))
    kw = dict(block_d=d["block_d"], tile_p=d["tile_p"])
    batched = "batch" in d
    ref_fn = ref_scatter.impact_scatter_batched if batched else ref_scatter.impact_scatter
    port_fn = scatter_ops.impact_scatter_batched if batched else scatter_ops.impact_scatter
    want = ref_fn(jnp.asarray(docs), jnp.asarray(contribs), d["n_docs"], interpret=True, **kw)
    got = port_fn(torch.as_tensor(docs), torch.as_tensor(contribs), d["n_docs"], **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ref_fused.CONTRACT.shape_grid, ids=lambda c: c.name)
def test_impact_scatter_topk_contract_shapes(case):
    d = case.dims
    docs, contribs, live = _inputs(d, seed=100 + len(case.name))
    kw = dict(block_d=d["block_d"], tile_p=d["tile_p"])
    batched = "batch" in d
    ref_fn = ref_fused.impact_scatter_topk_batched if batched else ref_fused.impact_scatter_topk
    port_fn = fused_ops.impact_scatter_topk_batched if batched else fused_ops.impact_scatter_topk
    want_s, want_i = ref_fn(
        jnp.asarray(docs), jnp.asarray(contribs), d["n_docs"], d["k"],
        live=None if live is None else jnp.asarray(live), interpret=True, **kw,
    )
    got_s, got_i = port_fn(
        torch.as_tensor(docs), torch.as_tensor(contribs), d["n_docs"], d["k"],
        live=None if live is None else torch.as_tensor(live), **kw,
    )
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n_live", [(5, 700), (64, 40), (300, 700)])
def test_impact_scatter_topk_n_live_and_ties(k, n_live):
    """Masked ids past n_live and all-zero docs tie: lowest id first."""
    rng = np.random.default_rng(k)
    docs = rng.integers(0, 60, (2, 256)).astype(np.int32)
    contribs = rng.integers(0, 3, (2, 256)).astype(np.float32)  # zeros and integer ties
    want = ref_fused.impact_scatter_topk_batched(
        jnp.asarray(docs), jnp.asarray(contribs), 700, k, n_live=n_live,
        block_d=256, tile_p=128, interpret=True)
    got = fused_ops.impact_scatter_topk_batched(
        torch.as_tensor(docs), torch.as_tensor(contribs), 700, k, n_live=n_live,
        block_d=256, tile_p=128)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_sorted_posting_tiles_layout():
    """Rows sorted by doc, zero-contribution slots and tile padding on the
    sentinel doc at the tail, contributions in their original order per doc."""
    docs = torch.tensor([[5, 0, 3, 5, 0, 3, 7]], dtype=torch.int32)
    c = torch.tensor([[1.0, 0.0, 2.0, 3.0, 4.0, 0.0, 5.0]])
    d, s = common.sorted_posting_tiles(docs, c, n_docs_pad=8, tile_p=4)
    assert d.tolist() == [[0, 3, 5, 5, 7, 8, 8, 8]]
    assert s.tolist() == [[4.0, 2.0, 1.0, 3.0, 5.0, 0.0, 0.0, 0.0]]
    acc = impact_scatter_batched_ref(d, s, 8)
    assert acc.tolist() == [[4.0, 0.0, 0.0, 2.0, 0.0, 4.0, 0.0, 5.0]]


def test_plain_scatter_adds_in_row_order():
    """The CPU plain version sums each doc sequentially in row order, as the
    CUDA kernel does: bit-equal to a Python loop in float32."""
    rng = np.random.default_rng(5)
    docs = np.sort(rng.integers(0, 20, 500)).astype(np.int32)
    c = (rng.gamma(2.0, 1.0, 500) * 1e3).astype(np.float32)
    want = np.zeros(20, np.float32)
    for doc, x in zip(docs, c):
        want[doc] = np.float32(want[doc] + x)
    got = impact_scatter_batched_ref(torch.as_tensor(docs)[None], torch.as_tensor(c)[None], 20)[0]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_d", [32, 96, 2048])
def test_block_d_outside_the_kernel_range_is_refused(block_d):
    docs, c = torch.zeros((1, 8), dtype=torch.int32), torch.ones((1, 8))
    with pytest.raises(ValueError, match="block_d"):
        scatter_ops.impact_scatter_batched(docs, c, 100, block_d=block_d)
    with pytest.raises(ValueError, match="block_d"):
        fused_ops.impact_scatter_topk_batched(docs, c, 100, 5, block_d=block_d)
