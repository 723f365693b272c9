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
  count, the shared memory of each kernel, and the shapes past the limit;
* the scatter kernels' staged accumulation (``block_doc_sums`` in
  ``csrc/scatter_common.cuh``), modelled in numpy: the doc starts its scan
  finds in each shared-memory stage are the per-doc lower bounds, and the
  sums carried across stages equal each doc's run added in row order, bit
  for bit (empty docs, one-doc blocks, ranges over several stages);
* ``impact_scatter_topk``'s rule between the select and the sort, at its
  boundary, and the shared memory of both; the store-addressed scorer's
  docs per CTA.

On a card (marker ``cuda``; they skip here): ``block_topk``, both
``chunk_step`` launchers, ``sparse_score``'s store-addressed entry and
``impact_scatter_topk`` against their plain versions, bit for bit, at the
edges: ties, all--inf rows, ragged widths, B = 1 and 63, k = 1000,
tombstones, rows that leave a multi-trip launch at different trips, pad
docs, rows with no padding or no terms, empty blocks and ranges over
several stages. The scoring inputs have small integer weights, so every sum
is exact in any order and the scores can be compared bit for bit.
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
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops
from repro_torch.kernels.impact_scatter_topk import ref as fused_ref
from repro_torch.kernels.sparse_score import ops as score_ops
from repro_torch.kernels.sparse_score import ref as score_ref

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
# the scatter kernels' staged accumulation, modelled
# ---------------------------------------------------------------------------


def _staged_block_sums(docs, contribs, block_start, block_d, stage):
    """``block_doc_sums`` step for step on one sorted row: the block's range
    [lo, hi), then each stage of at most ``stage`` postings: the run starts
    its scan writes (a posting whose doc differs from its predecessor's
    starts that doc's run; the docs between take the same start; docs past
    the stage's last doc start at its end), and each doc's run added in
    order onto the sum carried from the earlier stages. Returns the sums and
    each stage's (first posting, per-doc start) pairs."""
    lo = int(np.searchsorted(docs, block_start, "left"))
    hi = int(np.searchsorted(docs, block_start + block_d, "left"))
    acc = np.zeros(block_d, np.float32)
    stages = []
    for p0 in range(lo, hi, stage):
        n = min(stage, hi - p0)
        ids = docs[p0:p0 + n] - block_start
        vals = contribs[p0:p0 + n]
        start = np.full(block_d, -1)
        for i in range(n):
            for e in range((-1 if i == 0 else ids[i - 1]) + 1, ids[i] + 1):
                start[e] = i
        last = ids[n - 1]
        begin = np.array([start[t] if t <= last else n for t in range(block_d)])
        end = np.array([start[t + 1] if t < last else n for t in range(block_d)])
        for t in range(block_d):
            for p in range(begin[t], end[t]):
                acc[t] = np.float32(acc[t] + vals[p])
        stages.append((p0, begin, end))
    return acc, stages


def _check_staged(docs, contribs, block_d, stage):
    n_blocks = -(-int(docs.max(initial=0) + 1) // block_d)
    for blk in range(n_blocks):
        start = blk * block_d
        acc, stages = _staged_block_sums(docs, contribs, start, block_d, stage)
        for p0, begin, end in stages:
            n = len(docs[p0:p0 + stage])
            row = docs[p0:min(p0 + stage, len(docs))]
            # a doc's start in the stage is its lower bound in the stage's slice,
            # clamped to the block's range
            keys = start + np.arange(block_d + 1)
            lb = np.minimum(np.searchsorted(row, keys, "left"), n)
            hi = int(np.searchsorted(docs, start + block_d, "left")) - p0
            lb = np.minimum(lb, hi)
            assert np.array_equal(begin, lb[:-1]) and np.array_equal(end, lb[1:])
        # the per-doc lower bounds over the whole row, each run added in row order
        bounds = np.searchsorted(docs, start + np.arange(block_d + 1), "left")
        want = np.zeros(block_d, np.float32)
        for t in range(block_d):
            for p in range(bounds[t], bounds[t + 1]):
                want[t] = np.float32(want[t] + contribs[p])
        assert np.array_equal(acc.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", ["empty_docs", "one_doc_blocks", "stage_spanning", "empty_block"])
def test_staged_doc_starts_are_the_per_doc_lower_bounds(case):
    rng = np.random.default_rng(len(case))
    block_d, stage = 16, 4 * 16
    if case == "empty_docs":  # most docs have no posting
        docs = rng.choice(np.arange(0, 64, 5), 40)
    elif case == "one_doc_blocks":  # every posting of a block on one doc
        docs = np.repeat([3, 20, 47], [5, 1, 9])
    elif case == "stage_spanning":  # a block's range over several stages
        docs = rng.integers(16, 32, 5 * stage + 3)
    else:  # a block with no postings between two that have some
        docs = np.concatenate([rng.integers(0, 16, 30), rng.integers(32, 48, 30)])
    docs = np.sort(docs).astype(np.int32)
    contribs = rng.gamma(2.0, 1.0, len(docs)).astype(np.float32)
    _check_staged(docs, contribs, block_d, stage)


@settings(max_examples=60, deadline=None)
@given(
    n=st.integers(0, 300),
    n_docs=st.integers(1, 100),
    block_d=st.sampled_from([8, 16, 32]),
    per_thread=st.integers(1, 4),
    seed=st.integers(0, 2**31 - 1),
)
def test_staged_block_sums_equal_row_order_sums(n, n_docs, block_d, per_thread, seed):
    rng = np.random.default_rng(seed)
    docs = np.sort(rng.integers(0, n_docs, n)).astype(np.int32)
    contribs = rng.gamma(2.0, 1.0, n).astype(np.float32)
    _check_staged(docs, contribs, block_d, per_thread * block_d)


# ---------------------------------------------------------------------------
# launch logic# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("k_blk,select", [(1, True), (10, True), (16, True), (32, True),
                                           (33, False), (64, False), (512, False)])
def test_select_or_sort_rule_at_its_boundary(k_blk, select):
    assert fused_ops.SELECT_MAX_K == 32
    assert fused_ops.use_select(k_blk) is select
    lay = fused_ops.impact_scatter_topk_layout(512, k_blk)
    shape = common.scatter_shape(512)
    list_len = min(k_blk, 32 * shape["dpt"])
    n_keys = shape["threads"] // 32 * list_len if select else 512
    assert lay == dict(shape, select=select, list_len=list_len, n_keys=n_keys,
                       smem=8 * n_keys + 4 * 512 + shape["smem"])


@pytest.mark.parametrize("block_d,dpt", [(64, 1), (128, 2), (256, 4), (512, 4), (1024, 4)])
def test_scatter_shape_fits_every_block_d(block_d, dpt):
    shape = common.scatter_shape(block_d)
    assert shape["dpt"] == dpt and shape["threads"] == block_d // dpt >= 64
    assert shape["threads"] % 32 == 0
    # the stage (8 B a posting) and the run starts (4 B a doc)
    assert shape["smem"] == 8 * shape["stage"] + 4 * block_d
    for k in (1, 10, 32, 33, block_d):
        assert fused_ops.impact_scatter_topk_layout(block_d, k)["smem"] <= common.SMEM_LIMIT


@pytest.mark.parametrize("batch,n,n_sms,span", [
    (64, 2048, 132, 32), (64, 1024, 132, 32), (63, 2048, 132, 32), (1, 2048, 132, 8),
    (1, 100_000, 132, 32), (4, 2048, 132, 8), (10, 2048, 132, 16), (4, 8, 132, 8),
])
def test_store_scorer_docs_per_cta(batch, n, n_sms, span):
    """32 docs a CTA, fewer (a multiple of the CTA's 8 warps, at least 8)
    where the batch would leave some of the card's CTA slots empty."""
    assert score_ops.docs_per_cta(batch, n, n_sms) == span
    assert span % 8 == 0
    if span < score_ops.MAX_DOCS_PER_CTA:
        assert batch * -(-n // span) >= min(n_sms * score_ops.CTAS_PER_SM, batch * -(-n // 8))


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


def _store_case(seed, batch, *, n_blocks=6, bs=32, nb=4, tmax=75, lq=6, vocab=100):
    """A doc store as build_impact_index lays it out, doc 0 with no padding
    and doc 1 with no terms, integer weights; queries that repeat a term and
    carry a zero-weight slot; each query's blocks, always block 0 and the
    last block, whose last 5 docs are pad docs."""
    rng = np.random.default_rng(seed)
    n_docs = n_blocks * bs
    dt = np.full((n_docs, tmax), vocab, np.int32)
    dw = np.zeros((n_docs, tmax), np.float32)
    for d in range(n_docs):
        n = tmax if d == 0 else 0 if d == 1 else int(rng.integers(0, tmax + 1))
        dt[d, :n] = np.sort(rng.choice(vocab, n, replace=False))
        dw[d, :n] = rng.integers(1, 4, n)
    qt = rng.integers(0, vocab, (batch, lq)).astype(np.int32)
    qw = rng.integers(1, 3, (batch, lq)).astype(np.float32)
    qt[:, 1], qw[:, 2] = qt[:, 0], 0.0
    ids = np.stack([np.concatenate([[0, n_blocks - 1],
                                    1 + rng.choice(n_blocks - 2, nb - 2, replace=False)])
                    for _ in range(batch)]).astype(np.int32)
    live = torch.as_tensor(rng.random(n_docs) < 0.8, dtype=torch.int32)
    gate = torch.as_tensor(rng.random((batch, nb)) < 0.7)
    return [torch.as_tensor(a) for a in (dt, dw, ids, qt, qw)], live, gate, n_docs - 5


@pytest.mark.cuda
@pytest.mark.parametrize("batch,live,gate", [
    (1, False, False), (63, False, False), (64, True, False), (64, False, True), (64, True, True),
])
def test_sparse_score_store_kernel_bit_for_bit(batch, live, gate):
    dev = _cuda()
    args, mask, block_live, n_live = _store_case(batch + 7 * live + 3 * gate, batch)
    kw = dict(block_size=32, n_live=n_live, live=mask if live else None,
              block_live=block_live if gate else None)
    got = score_ops.sparse_score_blocks_launch(
        *(a.to(dev) for a in args), **{k: v.to(dev) if torch.is_tensor(v) else v
                                       for k, v in kw.items()})
    assert torch.equal(got.cpu(), score_ref.sparse_score_blocks_ref(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("live", [False, True])
@pytest.mark.parametrize("k", [1, 10, 16, 32, 33, 512])
def test_impact_scatter_topk_edges_bit_for_bit(k, live):
    """An empty block, a range over more than three stages, a block of tombstoned
    docs, pad docs in the last block and tied integer contributions."""
    dev = _cuda()
    rng = np.random.default_rng(k)
    bd, n_docs, n_pad = 512, 4000, 4096
    docs = rng.integers(0, n_docs, (3, 6000))
    docs = np.where(docs // bd == 2, docs - bd, docs)
    stage = common.scatter_shape(bd)["stage"]
    docs = np.concatenate([docs, rng.integers(5 * bd, 6 * bd, (3, 3 * stage + 100))], axis=1)
    c = rng.integers(1, 4, docs.shape).astype(np.float32)
    docs, c = common.sorted_posting_tiles(torch.as_tensor(docs), torch.as_tensor(c), n_pad, 512)
    mask = None
    if live:
        m = rng.random(n_pad) < 0.9
        m[6 * bd:7 * bd] = False
        mask = torch.as_tensor(m, dtype=torch.int32)
    k_blk = min(k, bd)
    gs, gi = fused_ops.impact_scatter_topk_launch(docs.to(dev), c.to(dev), n_pad, n_docs, k_blk,
                                                  bd, None if mask is None else mask.to(dev))
    ws, wi = fused_ref.impact_scatter_topk_block_ref(docs, c, n_pad, n_docs, k_blk, bd, mask)
    assert torch.equal(gs.cpu(), ws) and torch.equal(gi.cpu(), wi)
