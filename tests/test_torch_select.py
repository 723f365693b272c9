"""The selects of the redesigned DAAT kernels (``csrc/select_common.cuh``,
``csrc/block_topk.cu``, ``csrc/chunk_step.cu``) and what their designs rest on.

On the CPU:

* the chunk-step merge's premise: a candidate that does not score above the
  pool's lowest score never enters the pool, so merging the pool with only
  the candidates above it gives the pool that merging with all of them
  gives (``merge_topk``, heavily tied scores, ``-inf`` pools, k past the
  finite entries);
* the two-level select (each warp's n best by rounds of a warp-wide max,
  then a merge of the warps' lists), modelled in numpy, equals ``topk`` on
  tied scores, with lists shorter than n where a warp owns fewer keys;
* the scorer's stop at a row's padding: in ``build_impact_index``'s doc
  store a chunk of 32 slots that holds one term id in two or more valid
  slots is padding, and so is the rest of the row;
* the wrappers' launch logic: the cluster size from the batch and the SM
  count, the shared memory of each kernel, and the shapes past the limit.

On a card (marker ``cuda``; they skip here): ``block_topk`` and both
``chunk_step`` launchers against their plain versions, bit for bit, at the
edges: ties, all--inf rows, ragged widths, B = 1 and 63, k = 1000,
tombstones, rows that leave a multi-trip launch at different trips. The
chunk-step inputs have small integer weights, so every sum is exact in any
order and the scores can be compared bit for bit.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import build_impact_index
from repro_torch.core.topk import merge_topk, topk
from repro_torch.kernels import common
from repro_torch.kernels.block_topk import ops as btopk_ops
from repro_torch.kernels.block_topk import ref as btopk_ref
from repro_torch.kernels.chunk_step import ops as chunk_ops
from repro_torch.kernels.chunk_step import ref as chunk_ref

pytestmark = pytest.mark.torch_port

NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# the merge's premise
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(
    k=st.integers(1, 12),
    n_cand=st.integers(0, 40),
    levels=st.integers(1, 4),
    neg_inf_share=st.sampled_from([0.0, 0.3, 1.0]),
    sort_pool=st.booleans(),
    seed=st.integers(0, 2**31 - 1),
)
def test_merge_with_only_candidates_above_the_pool_minimum_is_the_full_merge(
        k, n_cand, levels, neg_inf_share, sort_pool, seed):
    rng = np.random.default_rng(seed)

    def scores(n):
        s = rng.integers(0, levels, n).astype(np.float32)
        s[rng.random(n) < neg_inf_share] = -np.inf
        return torch.as_tensor(s)

    pool_s = scores(k)
    if sort_pool:
        pool_s = torch.sort(pool_s, descending=True, stable=True).values
    pool_i = torch.as_tensor(rng.permutation(1000)[:k], dtype=torch.int32)
    cand_s = scores(n_cand)
    cand_i = torch.arange(1000, 1000 + n_cand, dtype=torch.int32)
    keep = cand_s > pool_s.min()
    full = merge_topk(pool_s, pool_i, cand_s, cand_i, k)
    kept = merge_topk(pool_s, pool_i, cand_s[keep], cand_i[keep], k)
    assert torch.equal(full[0], kept[0]) and torch.equal(full[1], kept[1])


# ---------------------------------------------------------------------------
# the two-level select, modelled
# ---------------------------------------------------------------------------


def _select_model(keys: np.ndarray, threads: int, n: int) -> list[int]:
    """``block_select_desc`` step for step: thread t owns keys t, t +
    threads, ...; warp w keeps the best ``list_len`` of its threads' keys by
    rounds of a max, lanes rescanning below the key just taken; warp 0
    merges the lists by rounds of a max over their heads."""
    m = len(keys)
    list_len = btopk_ops.select_list_len(m, n, threads)

    def lane_best(t, below):
        own = [int(keys[i]) for i in range(t, m, threads) if int(keys[i]) < below]
        return max(own, default=0)

    lists = []
    for w in range(threads // 32):
        mine = [lane_best(t, 2**64) for t in range(32 * w, 32 * w + 32)]
        out = []
        for _ in range(list_len):
            best = max(mine)
            out.append(best)
            if best == 0:
                out += [0] * (list_len - len(out))
                break
            lane = mine.index(best)
            mine[lane] = lane_best(32 * w + lane, best)
        lists.append(out)
    heads = [0] * len(lists)
    result = []
    for _ in range(n):
        cur = [lst[p] if p < list_len else 0 for lst, p in zip(lists, heads)]
        best = max(cur)
        result.append(best)
        if best:
            heads[cur.index(best)] += 1
    return result


def _keys(scores: np.ndarray) -> np.ndarray:
    """select_key: the float's order-preserving bits above 0xFFFFFFFF - index."""
    u = scores.astype(np.float32).view(np.uint32).astype(np.uint64)
    ordered = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (ordered << np.uint64(32)) | (0xFFFFFFFF - np.arange(len(scores), dtype=np.uint64))


@pytest.mark.parametrize("m,n,threads", [
    (2159, 16, 1024), (2159, 8, 1024), (2159, 1, 1024), (45, 7, 64), (100, 100, 128),
    (1001, 1000, 1024), (700, 40, 256),
])
def test_two_level_select_equals_topk(m, n, threads):
    rng = np.random.default_rng(m + n)
    s = rng.integers(0, 4, m).astype(np.float32)
    s[rng.random(m) < 0.1] = -np.inf
    got = _select_model(_keys(s), threads, n)
    want_s, want_i = topk(torch.as_tensor(s), n)
    idx = [0xFFFFFFFF - (key & 0xFFFFFFFF) for key in got]
    assert idx == want_i.tolist()
    assert np.array_equal(s[idx], want_s.numpy())


# ---------------------------------------------------------------------------
# the scorer's stop at a row's padding
# ---------------------------------------------------------------------------


def test_doc_store_rows_stop_at_their_padding():
    """In the store a row's first chunk of 32 slots whose two or more valid
    slots hold one term id starts the row's padding: no real term follows,
    and no real term is skipped."""
    rng = np.random.default_rng(0)
    n_docs, n_terms = 300, 200
    d = rng.integers(0, n_docs, 15000)
    t = rng.integers(0, n_terms, 15000)
    w = rng.gamma(2.0, 1.0, 15000)
    index = build_impact_index(d, t, w, n_docs, n_terms, block_size=32, device="cpu")
    terms = index.doc_terms.numpy()
    tmax = terms.shape[1]
    assert tmax > 32
    for row, n_real in zip(terms, index.doc_n_terms.numpy()):
        stop = tmax
        for c in range(0, tmax, 32):
            chunk = row[c:c + 32]
            if len(chunk) >= 2 and (chunk == chunk[0]).all():
                stop = c
                break
        assert (row[stop:] == n_terms).all()
        assert stop >= n_real and len(set(row[:n_real])) == n_real


# ---------------------------------------------------------------------------
# launch logic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch,n_sms,size", [
    (64, 132, 2), (63, 132, 2), (1, 132, 8), (33, 132, 4), (66, 132, 2), (67, 132, 1),
    (200, 132, 1), (16, 132, 8), (64, 128, 2), (64, 127, 1),
])
def test_cluster_size_from_batch_and_sms(batch, n_sms, size):
    assert chunk_ops.cluster_size(batch, n_sms) == size
    assert 1 <= size <= chunk_ops.MAX_CLUSTER
    assert size == 1 or batch * size <= n_sms


@pytest.mark.parametrize("nb,k,budget,bs,want", [
    # the engine's spladev2 shard at k = 10 and k = 1000; the contract's index
    (2159, 10, 16, 128, dict(list_len=16, n_keys=4096, smem=52043)),
    (2159, 1000, 16, 128, dict(list_len=16, n_keys=4096, smem=59963)),
    (7, 5, 3, 32, dict(list_len=3, n_keys=128, smem=8 * 131 + 4 * (7 + 96 + 10 + 3) + 10)),
])
def test_chunk_step_layout(nb, k, budget, bs, want):
    assert chunk_ops.chunk_step_layout(nb, k, budget, bs) == want


def test_chunk_step_layout_rejects_states_past_shared_memory():
    chunk_ops.chunk_step_layout(20_000, 1000, 16, 128)
    with pytest.raises(ValueError, match="shared memory"):
        chunk_ops.chunk_step_layout(40_000, 1000, 16, 128)
    with pytest.raises(ValueError, match="shared memory"):
        chunk_ops.chunk_step_layout(2159, 10, 160, 128)


@pytest.mark.parametrize("tile,k,threads,list_len", [
    (2159, 16, 1024, 16), (2159, 1, 1024, 1), (128, 100, 128, 32), (45, 7, 64, 7),
    (16384, 16384, 1024, 512),
])
def test_block_topk_launch_shape(tile, k, threads, list_len):
    assert btopk_ops.select_threads(tile) == threads
    assert btopk_ops.select_list_len(tile, k, threads) == list_len
    smem = btopk_ops.block_topk_smem(tile, k)
    assert smem == 8 * (threads // 32) * list_len + 4 * tile
    assert smem <= common.SMEM_LIMIT


def test_block_topk_smem_past_the_limit():
    assert btopk_ops.block_topk_smem(60_000, 16) > common.SMEM_LIMIT


# ---------------------------------------------------------------------------
# on the card: bit for bit against the plain versions
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


def _tied(shape, seed, neg_inf_rows=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = -np.inf
    s[:neg_inf_rows] = -np.inf
    return torch.as_tensor(s)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,k,neg_inf_rows", [
    (64, 2159, 1, 0), (64, 2159, 8, 0), (64, 2159, 16, 0), (4, 2159, 16, 2), (5, 45, 7, 0),
    (3, 1001, 1000, 1), (2, 45, 60, 0), (1, 2159, 16, 0),
])
def test_block_topk_kernel_bit_for_bit(batch, n, k, neg_inf_rows):
    dev = _cuda()
    scores = _tied((batch, n), n + k, neg_inf_rows)
    tile = min(8192, max(128, n))
    s = common.pad_axis(scores, 1, tile, fill=NEG_INF).contiguous()
    k_tile = min(max(min(k, n), 1), tile)
    gs, gi = btopk_ops.block_topk_launch(s.to(dev), k_tile, tile)
    ws, wi = btopk_ref.block_topk_stage1_ref(s, k_tile, tile)
    assert torch.equal(gs.cpu(), ws) and torch.equal(gi.cpu(), wi)
    if batch == 1:
        got = [t[None] for t in btopk_ops.block_topk(scores[0].to(dev), k)]
    else:
        got = btopk_ops.block_topk_batched(scores.to(dev), k)
    want = btopk_ops.block_topk_batched(scores, k)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def _chunk_inputs(seed, batch, k, nb=20, bs=32, tmax=75, lq=6, vocab=100, live=False):
    """A doc store as build_impact_index lays it out (distinct ascending terms,
    then the pad term), integer weights, and a sorted integer pool whose
    theta is its k-th score (all -inf in row 0)."""
    rng = np.random.default_rng(seed)
    n_docs = nb * bs
    dt = np.full((n_docs, tmax), vocab, np.int32)
    dw = np.zeros((n_docs, tmax), np.float32)
    for d in range(n_docs):
        n = int(rng.integers(0, tmax + 1))
        dt[d, :n] = np.sort(rng.choice(vocab, n, replace=False))
        dw[d, :n] = rng.integers(1, 4, n)
    qt = rng.integers(0, vocab, (batch, lq)).astype(np.int32)
    qw = rng.integers(0, 3, (batch, lq)).astype(np.float32)
    ub = rng.integers(0, 60, (batch, nb)).astype(np.float32)
    processed = rng.random((batch, nb)) < 0.2
    pool_s = -np.sort(-rng.integers(0, 40, (batch, k)), axis=1).astype(np.float32)
    pool_s[0] = -np.inf
    pool_i = rng.integers(0, n_docs, (batch, k)).astype(np.int32)
    state = [torch.as_tensor(a) for a in (dt, dw, qt, qw, ub, processed, pool_s, pool_i,
                                          pool_s[:, -1].copy())]
    mask = torch.as_tensor(rng.random(n_docs) < 0.8, dtype=torch.int32) if live else None
    return state, mask, n_docs - 5


@pytest.mark.cuda
@pytest.mark.parametrize("batch,k,budget,live,trips", [
    (1, 5, 3, False, None), (3, 1, 7, False, None), (63, 5, 3, False, None),
    (64, 1000, 16, False, None), (4, 5, 3, True, None),
    (1, 5, 3, False, 4), (63, 5, 2, False, 6), (64, 1000, 16, False, 3), (4, 5, 3, True, 4),
])
def test_chunk_step_kernels_bit_for_bit(batch, k, budget, live, trips):
    dev = _cuda()
    state, mask, n_live = _chunk_inputs(batch * 31 + k, batch, k, live=live)
    kw = dict(block_budget=budget, block_size=32, n_live=n_live)
    on_card = [t.to(dev) for t in state]
    mask_card = None if mask is None else mask.to(dev)
    if trips is None:
        got = chunk_ops.chunk_step_batched(*on_card, live=mask_card, **kw)
        want = chunk_ref.chunk_step_batched_ref(*state, live=mask, **kw)
    else:
        # rows leave the launch at different trips: their budgets differ
        trips_left = (1 + torch.arange(batch) % trips).to(torch.int32)
        got = chunk_ops.chunk_step_multi_batched(*on_card, trips_left.to(dev),
                                                 trips_per_launch=trips, live=mask_card, **kw)
        want = chunk_ref.chunk_step_multi_batched_ref(*state, trips_left, trips_per_launch=trips,
                                                      live=mask, **kw)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w)
