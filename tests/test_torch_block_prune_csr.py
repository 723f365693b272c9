"""``block_prune_csr`` (DAAT phase 0) as the Hopper kernel computes it.

The kernel (``csrc/block_prune_csr.cu``) gives each CTA a (query, tile of
blocks). For each slot it finds the tile's entries of the slot's window by
an 8-ary search over the window's ascending block ids (7 loads a round),
started in the range that distinct ids in ``[0, NB)`` leave for the answer,
reads the sub-windows
of a round of slots as one flat range into a dense [group, tile] tile of
products, and sums each block's column in slot order. On the CPU:

* a numpy model of that tiling (the search, the flat range, the dense tile
  and the column sums, in float32) is held bit for bit against the plain
  version at the tile edges: entries on both sides of a tile boundary,
  windows cut at the end of the lists, empty pad slots, ``NB`` not a
  multiple of the tile, several rounds of slots, ``B = 1`` and
  ``theta = -inf``;
* the model's search, and the range it starts in, against
  ``np.searchsorted`` (cases and hypothesis);
* the launch layout (``prune_csr_layout``);
* the kernel's precondition: block ids ascend within every term's list, for
  each index builder of the port (``build_impact_index``,
  ``index_from_numpy`` of a reference index, an ``IndexHandle``'s delta
  and compacted indexes); and for the same builders, the precondition of
  ``impact_scatter_topk``'s segment entry (the fused SAAT route), whose
  kernel binary-searches a segment for a doc range: doc ids ascend within
  every segment.

On a card (marker ``cuda``; they skip here): the kernel against its plain
version bit for bit at the same edges and tiles.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import (
    ARRAY_FIELDS,
    META_FIELDS,
    IndexHandle,
    build_impact_index,
    index_from_numpy,
)
from repro_torch.kernels import common
from repro_torch.kernels.block_prune_csr import ops as prune_ops
from repro_torch.kernels.block_prune_csr.ref import block_prune_csr_batched_ref

pytestmark = pytest.mark.torch_port

PROBES = 7  # loads a search round in the kernel


def _lower_bound(a, lo, hi, key):
    """The kernel's 8-ary ``lower_bound``: ``(index, rounds of loads)``."""
    rounds = 0
    while hi - lo > PROBES:
        step = (hi - lo) // (PROBES + 1)
        pos = [lo + step * (q + 1) for q in range(PROBES)]
        v = [int(a[p]) for p in pos]
        new_lo, new_hi = lo, hi
        for p, x in zip(pos, v):
            if x < key:
                new_lo = p + 1
        for p, x in zip(reversed(pos), reversed(v)):
            if x >= key:
                new_hi = p
        lo, hi = new_lo, new_hi
        rounds += 1
    below = sum(1 for q in range(PROBES) if lo + q < hi and a[lo + q] < key)
    return lo + below, rounds + 1


def _search_range(s, c, n_blocks, key):
    """Where the kernel starts the search: ``c`` distinct ids in
    ``[0, n_blocks)`` put at most ``key`` and at least ``c - (n_blocks -
    key)`` of them under ``key``."""
    return s + max(0, c - (n_blocks - key)), s + min(c, key)


def _model(bm_block, bm_weight, base, cnt, qw, theta, n_blocks, tile):
    """numpy model of the kernel: ``(ub f32, survive bool)[B, n_blocks]``."""
    B, lq = base.shape
    n_bm = bm_block.shape[0]
    group = prune_ops.prune_csr_layout(lq, n_blocks, tile)["group"]
    ub = np.zeros((B, n_blocks), np.float32)
    for b in range(B):
        for tile0 in range(0, n_blocks, tile):
            width = min(tile, n_blocks - tile0)
            tile1 = tile0 + width
            acc = np.zeros(width, np.float32)
            for g0 in range(0, lq, group):
                ng = min(group, lq - g0)
                lo, hi, w = [], [], []
                for l in range(g0, g0 + ng):
                    s = int(base[b, l])
                    c = max(0, min(int(cnt[b, l]), n_bm - s))
                    for out, key in ((lo, tile0), (hi, tile1)):
                        out.append(_lower_bound(bm_block, *_search_range(s, c, n_blocks, key),
                                                key)[0])
                    w.append(np.float32(qw[b, l]))
                pre = np.concatenate([[0], np.cumsum(np.maximum(0, np.subtract(hi, lo)))])
                dense = np.zeros((ng, tile), np.float32)
                for j in range(int(pre[-1])):
                    l = int(np.searchsorted(pre[:ng], j, side="right")) - 1
                    i = lo[l] + j - int(pre[l])
                    blk = int(bm_block[i]) - tile0
                    if 0 <= blk < width:
                        dense[l, blk] = np.float32(bm_weight[i]) * w[l]
                for l in range(ng):
                    acc = (acc + dense[l, :width]).astype(np.float32)
            ub[b, tile0:tile1] = acc
    survive = (ub > theta[:, None]) & (ub > 0)
    return ub, survive


def _inputs(seed, batch, lq, nb, m, n_bm, tile=None, cut=False, empty=0.2):
    """CSR block-max lists (sorted unique block ids) and per-(query, slot)
    windows into them. ``tile``: also lists of blocks on both sides of every
    tile boundary. ``cut``: the last list's windows run past the end of the
    lists (the count is longer than the list). ``empty``: the share of pad
    slots (count 0, weight 0, start at the end of the lists)."""
    rng = np.random.default_rng(seed)
    lists = []
    if tile is not None:
        edges = [t for t0 in range(tile, nb, tile) for t in (t0 - 1, t0)]
        lists += [np.array(edges, np.int64), np.array(edges[::2], np.int64),
                  np.array(edges[1::2], np.int64), np.array([0, nb - 1], np.int64)]
    total = sum(len(x) for x in lists)
    while True:
        c = int(min(rng.integers(1, 2 * m + 1), nb))
        if total + c > n_bm:
            break
        lists.append(np.sort(rng.choice(nb, c, replace=False)))
        total += c
    bm_block = np.concatenate(lists).astype(np.int32)
    n_bm = bm_block.shape[0]
    bm_weight = rng.gamma(1.0, 1.0, n_bm).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum([len(x) for x in lists])[:-1]]).astype(np.int32)
    counts = np.array([len(x) for x in lists], np.int32)
    terms = rng.integers(0, len(lists), (batch, lq))
    if tile is not None:
        terms[:, : min(lq, 4)] = np.arange(min(lq, 4))  # every query reads the edge lists
    base = starts[terms]
    cnt = counts[terms]
    if cut:
        last = len(lists) - 1
        terms[:, -1] = last
        base[:, -1] = starts[last]
        cnt[:, -1] = counts[last] + 7  # runs past the end of the lists
    qw = rng.gamma(1.0, 1.0, terms.shape).astype(np.float32)
    pad = rng.random(terms.shape) < empty
    base[pad], cnt[pad], qw[pad] = n_bm, 0, 0.0
    theta = rng.uniform(0.0, 2.0, batch).astype(np.float32)
    theta[0] = -np.inf
    return bm_block, bm_weight, base, cnt, qw, theta


# (name, inputs, n_blocks, tiles): every case runs at each tile
EDGE_CASES = (
    ("tile_edges_b3", dict(seed=1, batch=3, lq=9, nb=384, m=40, n_bm=900, tile=128), (128,)),
    ("ragged_nb_b2", dict(seed=2, batch=2, lq=6, nb=300, m=60, n_bm=1200, tile=128), (64, 128)),
    ("cut_at_end_b2", dict(seed=3, batch=2, lq=5, nb=200, m=30, n_bm=400, cut=True), (64, 128)),
    ("all_pad_slots_b2", dict(seed=4, batch=2, lq=4, nb=100, m=10, n_bm=200, empty=1.0), (64,)),
    ("b1_neg_inf", dict(seed=5, batch=1, lq=8, nb=100, m=16, n_bm=800), (32, 128)),
    ("rounds_lq35_b2", dict(seed=6, batch=2, lq=35, nb=2159, m=900, n_bm=20000), (1024, 2048)),
    ("one_block", dict(seed=7, batch=2, lq=3, nb=1, m=1, n_bm=10), (1, 128)),
)


@pytest.mark.parametrize("name,kw,tiles", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_tiling_model_matches_the_plain_version_bit_for_bit(name, kw, tiles):
    nb = kw["nb"]
    args = _inputs(**kw)
    m = max(1, int(args[3].max()))
    want_ub, want_mask = block_prune_csr_batched_ref(
        *(torch.as_tensor(a) for a in args), n_blocks=nb, max_bm_per_term=m)
    assert np.isneginf(args[5][0])
    for tile in tiles:
        ub, survive = _model(*args, nb, tile)
        np.testing.assert_array_equal(ub.view(np.int32), want_ub.numpy().view(np.int32))
        np.testing.assert_array_equal(survive, want_mask.numpy())
    if name == "rounds_lq35_b2":  # more than one round of slots at these tiles
        assert all(prune_ops.prune_csr_layout(35, nb, t)["rounds"] > 1 for t in tiles)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 15, 16, 100, 816, 2159])
def test_search_model_finds_the_lower_bound(n):
    rng = np.random.default_rng(n)
    a = np.sort(rng.choice(4 * n + 10, n, replace=False)).astype(np.int64)
    for key in sorted({0, 1, 4 * n + 10, *a.tolist(), *(a + 1).tolist()}):
        got, rounds = _lower_bound(a, 0, n, key)
        assert got == np.searchsorted(a, key, side="left")
        assert rounds <= 5
    if n == 816:  # a window of the engine's average length: 4 rounds of loads
        assert max(_lower_bound(a, 0, n, int(k))[1] for k in a) == 4


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 5000), unique=True, max_size=300), st.integers(0, 5001),
       st.integers(0, 40))
def test_search_model_hypothesis(values, key, offset):
    a = np.array([-1] * offset + sorted(values), np.int64)  # a window not at the list's start
    got, _ = _lower_bound(a, offset, a.shape[0], key)
    assert got == offset + np.searchsorted(a[offset:], key, side="left")


@settings(max_examples=80, deadline=None)
@given(st.integers(1, 3000), st.data())
def test_search_range_holds_the_answer(n_blocks, data):
    """Distinct ids in [0, n_blocks): the answer lies in the range the
    kernel starts in, and the search from there finds it."""
    ids = data.draw(st.lists(st.integers(0, n_blocks - 1), unique=True, max_size=n_blocks))
    a = np.array([-5, -5] + sorted(ids), np.int64)  # the window starts at 2
    c = len(ids)
    for key in (0, n_blocks, data.draw(st.integers(0, n_blocks)), *ids[:3]):
        lo, hi = _search_range(2, c, n_blocks, key)
        want = 2 + int(np.searchsorted(a[2:], key, side="left"))
        assert lo <= want <= hi
        assert _lower_bound(a, lo, hi, key)[0] == want
    key = n_blocks // 2  # a window that holds every block: no search at all
    assert _search_range(2, n_blocks, n_blocks, key) == (2 + key, 2 + key)


@pytest.mark.parametrize("lq,tile,group,rounds", [
    (35, 128, 35, 1), (35, 256, 35, 1), (35, 512, 20, 2), (35, 1024, 10, 4),
    (1, 128, 1, 1), (0, 128, 1, 0), (200, 64, 160, 2),
])
def test_prune_csr_layout(lq, tile, group, rounds):
    lay = prune_ops.prune_csr_layout(lq, 2159, tile)
    assert (lay["group"], lay["rounds"]) == (group, rounds)
    assert lay["tiles"] == -(-2159 // tile)
    assert lay["smem"] == 4 * (group * tile + tile + 4 * group + 1) <= common.SMEM_LIMIT


@pytest.mark.parametrize("tile", [0, prune_ops.DENSE_CELLS + 1])
def test_prune_csr_layout_rejects_a_bad_tile(tile):
    with pytest.raises(ValueError, match="tile"):
        prune_ops.prune_csr_layout(35, 2159, tile)


# ---------------------------------------------------------------------------
# the kernel's precondition on every index builder of the port
# ---------------------------------------------------------------------------


def _assert_lists_ascend(index):
    blocks = index.bm_block.cpu().numpy().astype(np.int64)
    start = index.term_bm_start.cpu().numpy().astype(np.int64)
    count = index.term_bm_count.cpu().numpy().astype(np.int64)
    assert count.sum() == blocks.shape[0]
    term = np.repeat(np.arange(count.shape[0]), count)
    same_list = term[1:] == term[:-1]
    assert (np.diff(blocks)[same_list] > 0).all()
    assert ((blocks >= 0) & (blocks < index.n_blocks)).all()
    assert (start == np.concatenate([[0], np.cumsum(count)[:-1]])).all()


def _assert_segments_ascend(index):
    doc_ids = index.doc_ids.cpu().numpy().astype(np.int64)
    start = index.seg_start.cpu().numpy().astype(np.int64)
    length = index.seg_len.cpu().numpy().astype(np.int64)
    seg = np.repeat(np.arange(length.shape[0]), length)
    pos = np.repeat(start - np.concatenate([[0], np.cumsum(length)[:-1]]), length) + np.arange(
        seg.shape[0])
    docs = doc_ids[pos]
    same_seg = seg[1:] == seg[:-1]
    assert same_seg.any()
    assert (np.diff(docs)[same_seg] > 0).all()


def _coo(seed, n_docs=300, n_terms=50, n=3000):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_docs, n), rng.integers(0, n_terms, n), rng.gamma(2.0, 1.0, n),
            n_docs, n_terms)


def _handle(seed):
    d, t, w, n_docs, n_terms = _coo(seed)
    handle = IndexHandle.from_corpus(d, t, w, n_docs, n_terms, block_size=32, device="cpu")
    rng = np.random.default_rng(seed + 1)
    for _ in range(40):
        handle.add(rng.choice(n_terms, 6, replace=False), rng.gamma(2.0, 1.0, 6))
    handle.update(3, np.array([1, 4, 9]), np.array([0.5, 2.0, 1.0]))
    handle.delete(7)
    return handle


def _built(seed):
    return build_impact_index(*_coo(seed), block_size=32, device="cpu")


def _from_reference(seed):
    from repro.core import build_impact_index as ref_build  # the reference: JAX, CPU only

    ref = ref_build(*_coo(seed), block_size=32)
    arrays = {f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS}
    return index_from_numpy(arrays, {f: getattr(ref, f) for f in META_FIELDS}, device="cpu")


def _delta(seed):
    return _handle(seed).delta


def _compacted(seed):
    handle = _handle(seed)
    handle.compact()
    return handle.main


BUILDERS = {"build_impact_index": _built, "index_from_numpy": _from_reference,
            "handle_delta": _delta, "handle_compacted": _compacted}


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_block_ids_ascend_within_every_list(builder):
    for seed in (0, 1):
        index = BUILDERS[builder](seed)
        assert index is not None and index.bm_block.shape[0] > 0
        _assert_lists_ascend(index)


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_doc_ids_ascend_within_every_segment(builder):
    for seed in (0, 1):
        index = BUILDERS[builder](seed)
        assert index is not None and index.seg_len.shape[0] > 0
        _assert_segments_ascend(index)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,tiles", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_kernel_matches_the_plain_version_bit_for_bit(name, kw, tiles):
    dev = _cuda()
    nb = kw["nb"]
    args = _inputs(**kw)
    m = max(1, int(args[3].max()))
    want_ub, want_mask = block_prune_csr_batched_ref(
        *(torch.as_tensor(a) for a in args), n_blocks=nb, max_bm_per_term=m)
    cuda_args = tuple(torch.as_tensor(a, device=dev) for a in args)
    for tile in tiles + (prune_ops.PRUNE_TILE,):
        ub, survive = prune_ops.block_prune_csr_launch(*cuda_args, nb, tile)
        torch.cuda.synchronize()
        assert torch.equal(ub.cpu(), want_ub), (name, tile)
        assert torch.equal(survive.cpu(), want_mask), (name, tile)
