"""``impact_scatter`` (B2) and the dense ``block_prune`` (B8) as the Hopper
kernels compute them, and the launch path every wrapper shares.

B2 (``csrc/impact_scatter.cu``) partitions each row of doc-sorted postings
by slots: a CTA takes ``stages`` consecutive ranges of ``THREADS * spt``
slots in order, and each warp a unit of ``32 * spt`` slots of a range. The
run of a doc belongs to the unit that holds its first posting, whose lane
reads on past the unit's end (the range's later units, the ``EXTRA`` slots
staged after it, then one slot a load) until the run ends; each unit writes
zeros over its doc span, from after the previous slot's doc to its own last
slot's doc (to the last doc where the row's real postings end), then each
run's sum. A CTA of several ranges that starts in the sentinel tail reads
one slot and stops; every CTA stops after the range where the row's real
postings end. B8 (``csrc/block_prune.cu``) gives a CTA a (query, tile of
blocks), a thread a block, which stages a slab of ``SLAB`` block maxima of
the tile at a time and sums its column in slot order. On the CPU:

* a numpy model of B2's partition (ranges and the CTAs that take them,
  units, run ownership and the read past, the sentinel tail, the spans:
  every doc zeroed exactly once, each sum written once inside its span) is
  held bit for bit to
  ``impact_scatter_batched_ref`` at every ``spt`` and several ``stages``,
  on the contract grid and at the edges: a run across every range
  boundary, runs longer than a range, empty and all-sentinel rows, rows
  with no slots, postings only on the first or last doc, a sparse row whose
  spans pass thousands of docs, rows whose real postings end on a range boundary, and
  B = 1, 63 and 64 with ``n_docs`` not a multiple of a range; with integer
  contributions, also to the reference's Pallas kernel in interpret mode;
* a numpy model of B8's tiles and slab-by-slab, slot-ordered sum, bit for
  bit to ``block_prune_batched_ref`` at every tile, at ragged ``NB`` and at
  an ``Lq`` of several slabs, and (integer inputs) to the reference;
* B2's launch rule (``range_layout``);
* the launch helper: with a stand-in library in ``common._LIBS`` whose
  symbols are C-callable stubs with the signatures of the ``csrc/`` sources,
  every wrapper's launch sets its launcher's argument types once, passes
  its pointers whole (64 bits) and the current stream's raw handle, and
  raises on a failed launch.

On a card (marker ``cuda``; they skip here): both kernels bit for bit
against their plain versions at the same edges, at every layout and tile,
and the stream handle equal to the current stream's. The reference (and so
JAX) is imported only inside the CPU tests that call it, so the card's
tests run where JAX is not installed.
"""
import ctypes
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.block_prune import ops as prune_ops
from repro_torch.kernels.block_prune.ref import block_prune_batched_ref
from repro_torch.kernels.block_prune_csr import ops as csr_ops
from repro_torch.kernels.block_topk import ops as btopk_ops
from repro_torch.kernels.chunk_step import ops as chunk_ops
from repro_torch.kernels.impact_scatter import ops as scatter_ops
from repro_torch.kernels.impact_scatter.ref import impact_scatter_batched_ref
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops
from repro_torch.kernels.sparse_score import ops as score_ops

pytestmark = pytest.mark.torch_port

CSRC = Path(common.__file__).resolve().parents[1] / "csrc"


def _kernel_constant(source: str, name: str) -> int:
    """A ``constexpr int`` of a kernel source."""
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, (source, name)
    return int(m.group(1))


# The kernels' constants, read from their sources.
THREADS = _kernel_constant("impact_scatter.cu", "THREADS")
EXTRA = _kernel_constant("impact_scatter.cu", "EXTRA")
SLAB = _kernel_constant("block_prune.cu", "SLAB")
N_SMS = 132  # the H100's


# The reference's impact_scatter CONTRACT.shape_grid, copied (the card's
# tests collect this file without JAX); test_the_grid_is_the_references
# holds the copy to the original.
SCATTER_GRID = (
    ("single_tile", dict(n_postings=128, n_docs=512, block_d=256, tile_p=128)),
    ("ragged", dict(n_postings=1000, n_docs=1000, block_d=256, tile_p=128)),
    ("multi_tile", dict(n_postings=4096, n_docs=512, block_d=256, tile_p=128)),
    ("b1", dict(batch=1, n_postings=128, n_docs=700, block_d=256, tile_p=128)),
    ("b3_ragged", dict(batch=3, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
    ("b8", dict(batch=8, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
)


def _reference():
    """The reference's scatter and dense-prune ops modules, and ``jnp``."""
    import jax.numpy as jnp
    from repro.kernels.block_prune import ops as ref_prune
    from repro.kernels.impact_scatter import ops as ref_scatter
    return ref_scatter, ref_prune, jnp


def test_the_grid_is_the_references():
    ref_scatter, _, _ = _reference()
    assert tuple((c.name, c.dims) for c in ref_scatter.CONTRACT.shape_grid) == SCATTER_GRID


def test_the_wrappers_know_the_kernels_constants():
    assert scatter_ops.THREADS == THREADS and scatter_ops.EXTRA == EXTRA
    src = (CSRC / "block_prune.cu").read_text()
    assert all(f"case {t}: return launch<{t}>" in src for t in prune_ops.TILES)
    assert all(f"case {s}: return launch<{s}>" in (CSRC / "impact_scatter.cu").read_text()
               for s in scatter_ops.SLOTS_PER_THREAD)


# ---------------------------------------------------------------------------
# B2: the posting-range partition
# ---------------------------------------------------------------------------


def _scatter_row_model(docs, contribs, n_docs, spt, stages=1):
    """numpy model of the kernel on one row: ``f32[n_docs]``. Asserts that
    the units' spans zero every doc exactly once and that each run's sum is
    written once, inside its unit's span."""
    R, U = THREADS * spt, 32 * spt
    P = docs.shape[0]
    out = np.full(n_docs, np.nan, np.float32)
    zeroed = np.zeros(n_docs, np.int64)
    summed = np.zeros(n_docs, np.int64)
    sentinel = lambda i: int(docs[i]) if i < P else n_docs  # noqa: E731

    def sum_unit(r0, u0):
        end = min(U, P - r0 - u0)
        if end <= 0:
            return
        g = r0 + u0  # the unit's first slot in the row
        first = int(docs[g])
        if first >= n_docs and g > 0:
            return  # in the sentinel tail
        prev = int(docs[g - 1]) if g > 0 else -1
        nxt = int(docs[g + end]) if g + end < P else n_docs
        lo, hi = prev + 1, (n_docs - 1 if nxt >= n_docs else int(docs[g + end - 1]))
        sums = {}
        for i in range(g, g + end):
            d = int(docs[i])
            if d >= n_docs or d == (int(docs[i - 1]) if i > 0 else -1):
                continue
            acc, p = np.float32(0.0), i
            # staged: the range and EXTRA slots after it (the sentinel past P)
            while p < r0 + R + EXTRA and sentinel(p) == d:
                acc = np.float32(acc + contribs[p])
                p += 1
            if p == r0 + R + EXTRA:  # then one slot a load
                while p < P and docs[p] == d:
                    acc = np.float32(acc + contribs[p])
                    p += 1
            sums[d] = acc
        out[lo:hi + 1] = 0.0
        zeroed[lo:hi + 1] += 1
        for d, acc in sums.items():
            assert lo <= d <= hi, (g, lo, hi, d)
            out[d] = acc
            summed[d] += 1

    n_ranges = -(-P // R)
    if P == 0:
        out[:] = 0.0
        zeroed[:] += 1
    for j0 in range(0, n_ranges, stages):  # a CTA
        if stages > 1 and j0 > 0 and docs[j0 * R] >= n_docs:
            continue  # its first slot is in the tail
        for j in range(j0, min(j0 + stages, n_ranges)):
            r0 = j * R
            for u0 in range(0, R, U):  # the warps
                sum_unit(r0, u0)
            end = min(R, P - r0)
            if r0 + end >= P or docs[r0 + end] >= n_docs:
                break  # the row's real postings end in this range
    assert (zeroed == 1).all(), np.flatnonzero(zeroed != 1)[:10]
    assert (summed <= 1).all()
    return out


def _scatter_model(docs, contribs, n_docs, spt, stages=1):
    return np.stack([_scatter_row_model(d, c, n_docs, spt, stages)
                     for d, c in zip(docs, contribs)])


LAYOUTS = tuple((spt, stages) for spt in scatter_ops.SLOTS_PER_THREAD for stages in (1, 2, 3, 32))


def _sorted_row(runs, P, n_docs, rng, integer):
    """A row in the kernel's layout: ``runs`` [(doc, length)] in ascending
    doc order, then the sentinel ``n_docs`` out to ``P`` slots."""
    docs = np.full(P, n_docs, np.int32)
    c = np.zeros(P, np.float32)
    at = 0
    for d, n in runs:
        docs[at:at + n] = d
        c[at:at + n] = rng.integers(1, 4, n) if integer else rng.gamma(2.0, 1.0, n)
        at += n
    assert at <= P
    return docs, c


def _random_runs(rng, n_slots, n_docs, max_len=4, max_gap=5, start=0):
    runs, d, at = [], start, 0
    while at < n_slots:
        d += int(rng.integers(1, max_gap + 1))
        n = min(int(rng.integers(1, max_len + 1)), n_slots - at)
        if d >= n_docs:
            break
        runs.append((d, n))
        at += n
    return runs


def _crossing_runs(R, n_ranges, n_docs, rng):
    """Runs with one across every range boundary (the boundary's slot in its
    middle), random short runs between."""
    runs, at, d = [], 0, -1
    for k in range(1, n_ranges + 1):
        for dd, n in _random_runs(rng, k * R - 3 - at, n_docs, start=d):
            runs.append((dd, n))
            at, d = at + n, dd
        assert at == k * R - 3
        d += 1
        runs.append((d, 6))  # slots kR-3 .. kR+2
        at += 6
    return runs


def _edge_case(name, spt, integer=False):
    """``(docs i32[B, P], contribs f32[B, P], n_docs)`` in the kernel's
    layout for one edge case at ranges of ``THREADS * spt`` slots."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {spt} {integer}".encode()))
    R = THREADS * spt
    rows = []
    if name == "cross_every_boundary":
        n_docs, P = 8 * R, 4 * R + 64
        rows.append(_crossing_runs(R, 4, n_docs, rng))
        rows.append(_crossing_runs(R, 3, n_docs, rng))
    elif name == "runs_longer_than_a_range":
        n_docs, P = 512, 5 * R + 200
        rows.append([(3, R // 2), (7, R + EXTRA + 40), (8, 1), (9, 2 * R + 5)])
        rows.append([(0, R), (1, R + EXTRA), (2, R + EXTRA + 1), (5, 7)])
    elif name == "empty_and_all_sentinel_rows":
        n_docs, P = 3 * 512, 3 * R + 17
        rows += [[], _random_runs(rng, 2 * R, n_docs), []]
    elif name == "first_and_last_doc_only":
        n_docs, P = 2048, 2 * R
        rows += [[(n_docs - 1, 3)], [(0, 5)], [(0, 2), (n_docs - 1, R + 1)]]
    elif name == "sparse_spans":
        n_docs, P = 81920, 3 * R + 11
        rows.append(_random_runs(rng, 2 * R + 100, n_docs, max_len=2, max_gap=40))
        rows.append(_random_runs(rng, R // 3, n_docs, max_len=1, max_gap=4096))
    elif name == "ends_on_a_range_boundary":
        n_docs, P = 4 * R, 3 * R
        rows.append(_random_runs(rng, R, n_docs))
        rows.append(_random_runs(rng, 2 * R, n_docs))
    else:
        raise KeyError(name)
    out = [_sorted_row(r, P, n_docs, rng, integer) for r in rows]
    return np.stack([d for d, _ in out]), np.stack([c for _, c in out]), n_docs


EDGE_CASES = ("cross_every_boundary", "runs_longer_than_a_range", "empty_and_all_sentinel_rows",
              "first_and_last_doc_only", "sparse_spans", "ends_on_a_range_boundary")


def _plain(docs, c, n_docs):
    return impact_scatter_batched_ref(torch.as_tensor(docs), torch.as_tensor(c), n_docs).numpy()


def test_edge_cases_have_their_shape():
    """The edge inputs hold what their names say, at the smallest range."""
    spt = scatter_ops.SLOTS_PER_THREAD[0]
    R = THREADS * spt
    docs, _, n = _edge_case("cross_every_boundary", spt)
    for k in range(1, 4):
        assert docs[0, k * R - 1] == docs[0, k * R] < n
    docs, _, n = _edge_case("runs_longer_than_a_range", spt)
    assert (np.diff(np.flatnonzero(np.diff(docs[0]) != 0)) > R + EXTRA).any()
    docs, _, n = _edge_case("empty_and_all_sentinel_rows", spt)
    assert (docs[0] == n).all() and (docs[2] == n).all()
    docs, _, n = _edge_case("sparse_spans", spt)
    real = docs[1][docs[1] < n]
    assert (np.diff(real) > 2048).any()
    docs, _, n = _edge_case("ends_on_a_range_boundary", spt)
    assert docs[0, R - 1] < n <= docs[0, R]


@pytest.mark.parametrize("spt", scatter_ops.SLOTS_PER_THREAD)
@pytest.mark.parametrize("name", EDGE_CASES)
def test_range_model_matches_the_plain_version_at_the_edges(name, spt):
    """At 1, 2, 3 and 32 ranges a CTA: CTAs that cut a row every way."""
    docs, c, n_docs = _edge_case(name, spt)
    want = _plain(docs, c, n_docs)
    for stages in (1, 2, 3, 32):
        np.testing.assert_array_equal(_scatter_model(docs, c, n_docs, spt, stages), want)


def test_range_model_on_rows_of_no_slots():
    docs = np.zeros((2, 0), np.int32)
    out = _scatter_model(docs, np.zeros((2, 0), np.float32), 512, 2)
    np.testing.assert_array_equal(out, np.zeros((2, 512), np.float32))


def _raw(case_dims, seed, integer):
    rng = np.random.default_rng(seed)
    shape = (case_dims.get("batch", 1), case_dims["n_postings"])
    docs = rng.integers(0, case_dims["n_docs"], shape).astype(np.int32)
    c = (rng.integers(1, 4, shape) if integer else rng.gamma(2.0, 1.0, shape)).astype(np.float32)
    return docs, c


def _sorted(docs, c, n_docs, block_d, tile_p):
    n_pad = common.round_up(max(n_docs, block_d), block_d)
    sd, sc = common.sorted_posting_tiles(torch.as_tensor(docs), torch.as_tensor(c), n_pad, tile_p)
    return sd.numpy(), sc.numpy(), n_pad


@pytest.mark.parametrize("name,d", SCATTER_GRID, ids=[c[0] for c in SCATTER_GRID])
def test_range_model_on_the_contract_grid(name, d):
    """Bit for bit to the plain version at every spt (gamma weights), and to
    the reference's Pallas kernel in interpret mode (integer weights, whose
    sums any order gives exactly)."""
    ref_scatter, _, jnp = _reference()
    docs, c = _raw(d, len(name), integer=False)
    sd, sc, n_pad = _sorted(docs, c, d["n_docs"], d["block_d"], d["tile_p"])
    want = _plain(sd, sc, n_pad)
    for spt, stages in LAYOUTS:
        np.testing.assert_array_equal(_scatter_model(sd, sc, n_pad, spt, stages), want)
    docs, c = _raw(d, len(name), integer=True)
    sd, sc, n_pad = _sorted(docs, c, d["n_docs"], d["block_d"], d["tile_p"])
    ref = ref_scatter.impact_scatter_batched(jnp.asarray(docs), jnp.asarray(c), d["n_docs"],
                                             block_d=d["block_d"], tile_p=d["tile_p"],
                                             interpret=True)
    layout = scatter_ops.range_layout(sd.shape[0], sd.shape[1], n_pad, N_SMS)
    np.testing.assert_array_equal(_scatter_model(sd, sc, n_pad, *layout)[:, :d["n_docs"]],
                                  np.asarray(ref))


@pytest.mark.parametrize("name", ("cross_every_boundary", "runs_longer_than_a_range",
                                  "empty_and_all_sentinel_rows", "first_and_last_doc_only"))
def test_range_model_matches_the_reference_kernel_at_the_edges(name):
    """Integer weights through the reference's own wrapper (its sort and tile
    ranges) against the model on the port's sorted layout of the same
    postings: equal bit for bit, at one range a CTA and at two."""
    ref_scatter, _, jnp = _reference()
    spt = scatter_ops.SLOTS_PER_THREAD[0]
    docs, c, n_docs = _edge_case(name, spt, integer=True)
    raw_docs = np.where(docs < n_docs, docs, 0).astype(np.int32)  # the sentinel: no weight
    P = common.round_up(docs.shape[1], 128)
    raw_docs = np.pad(raw_docs, ((0, 0), (0, P - docs.shape[1])))
    raw_c = np.pad(c, ((0, 0), (0, P - docs.shape[1])))
    sd, sc, n_pad = _sorted(raw_docs, raw_c, n_docs, 256, 128)
    ref = ref_scatter.impact_scatter_batched(jnp.asarray(raw_docs), jnp.asarray(raw_c), n_docs,
                                             block_d=256, tile_p=128, interpret=True)
    for stages in (1, 2):
        np.testing.assert_array_equal(_scatter_model(sd, sc, n_pad, spt, stages)[:, :n_docs],
                                      np.asarray(ref))


@pytest.mark.parametrize("batch", [1, 63, 64])
def test_range_model_at_batch_sizes(batch):
    """Rows of different real lengths (empty to all real) over 5,000 docs
    padded to 5,120, not a multiple of any range, at the wrapper's layout
    and at one of the smallest ranges a CTA."""
    rng = np.random.default_rng(batch)
    n_docs, P = 5000, 4608
    lengths = rng.integers(0, P + 1, batch)
    lengths[0] = P if batch > 1 else lengths[0]
    docs = np.zeros((batch, P), np.int32)
    c = np.zeros((batch, P), np.float32)
    for b, n in enumerate(lengths):
        docs[b, :n] = rng.integers(0, n_docs, n)
        c[b, :n] = rng.gamma(2.0, 1.0, n)
    sd, sc, n_pad = _sorted(docs, c, n_docs, 512, 512)
    want = _plain(sd, sc, n_pad)
    smallest = (scatter_ops.SLOTS_PER_THREAD[0], 1)
    for layout in sorted({smallest, scatter_ops.range_layout(batch, sd.shape[1], n_pad, N_SMS)}):
        np.testing.assert_array_equal(_scatter_model(sd, sc, n_pad, *layout), want)


@pytest.mark.parametrize("batch,n_slots,n_docs,layout", [
    (64, 1_000_448, 276_480, (4, 8)), (1, 1_000_448, 276_480, (4, 1)),
    (64, 100_352, 276_480, (2, 1)), (1, 100_352, 276_480, (2, 1)),
    (8, 1_000_448, 276_480, (4, 1)), (32, 1_000_448, 276_480, (4, 4)),
    (64, 2_500_096, 276_480, (8, 8)), (63, 4096, 5120, (2, 1)), (1, 0, 512, (2, 1)),
    (0, 100, 512, (2, 1)),
])
def test_range_layout_rule(batch, n_slots, n_docs, layout):
    """Slots a thread: the least at or above the slots a doc (the most where
    none is); ranges a CTA: the most that still gives every SM
    ``CTAS_PER_SM`` CTAs (one where none does)."""
    assert scatter_ops.range_layout(batch, n_slots, n_docs, N_SMS) == layout
    spt, stages = layout
    assert spt * n_docs >= n_slots or spt == scatter_ops.SLOTS_PER_THREAD[-1]
    n_ranges = -(-n_slots // (THREADS * spt))
    if stages > 1:
        assert batch * -(-n_ranges // stages) >= scatter_ops.CTAS_PER_SM * N_SMS


# ---------------------------------------------------------------------------
# B8: the tile and the slot-ordered sum
# ---------------------------------------------------------------------------


def _prune_model(bm, qw, theta, tile):
    """numpy model of the kernel: a CTA a (query, tile), a thread a column,
    a slab of ``SLAB // tile`` slots at a time, each column summed slot by
    slot from 0."""
    B, lq, nb = bm.shape
    slots = SLAB // tile
    ub = np.zeros((B, nb), np.float32)
    for b in range(B):
        for j0 in range(0, nb, tile):
            acc = np.zeros(min(tile, nb - j0), np.float32)
            for l0 in range(0, lq, slots):
                slab = bm[b, l0:l0 + slots, j0:j0 + tile]
                for l in range(slab.shape[0]):
                    acc = (acc + (np.float32(qw[b, l0 + l]) * slab[l]).astype(np.float32)
                           ).astype(np.float32)
            ub[b, j0:j0 + tile] = acc
    return ub, (ub > theta[:, None]) & (ub > 0)


def _prune_inputs(batch, lq, nb, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        bm = rng.integers(0, 5, (batch, lq, nb)).astype(np.float32)
        qw = rng.integers(0, 4, (batch, lq)).astype(np.float32)
        theta = np.full(batch, 0.5 + lq * 3, np.float32)
    else:
        bm = rng.gamma(1.0, 1.0, (batch, lq, nb)).astype(np.float32)
        bm[rng.random(bm.shape) < 0.2] = 0.0
        qw = rng.gamma(1.0, 1.0, (batch, lq)).astype(np.float32)
        theta = np.quantile(np.einsum("bl,bln->bn", qw, bm), 0.7, axis=-1).astype(np.float32)
    return bm, qw, theta


PRUNE_SHAPES = ((1, 35, 2159), (3, 9, 300), (2, 300, 97), (4, 5, 17), (2, 3, 1), (2, 1, 64),
                (1, 520, 40))


@pytest.mark.parametrize("batch,lq,nb", PRUNE_SHAPES)
def test_prune_model_matches_the_plain_version(batch, lq, nb):
    """At every tile: ragged ``NB``, and ``Lq`` past one slab (300 slots
    are 10 slabs at a tile of 256, 520 three at 32)."""
    bm, qw, theta = _prune_inputs(batch, lq, nb, seed=lq * nb)
    want = block_prune_batched_ref(*(torch.as_tensor(a) for a in (bm, qw, theta)))
    for tile in prune_ops.TILES:
        ub, mask = _prune_model(bm, qw, theta, tile)
        np.testing.assert_array_equal(ub, want[0].numpy())
        np.testing.assert_array_equal(mask, want[1].numpy())


@pytest.mark.parametrize("batch,lq,nb", ((1, 35, 2159), (2, 300, 97), (3, 9, 300)))
def test_prune_model_matches_the_reference_kernel(batch, lq, nb):
    """Integer maxima and weights (exact in any order) against the
    reference's Pallas kernel in interpret mode, at the wrapper's tile."""
    _, ref_prune, jnp = _reference()
    bm, qw, theta = _prune_inputs(batch, lq, nb, seed=nb, integer=True)
    ref_ub, ref_mask = ref_prune.block_prune_batched(jnp.asarray(bm), jnp.asarray(qw),
                                                     jnp.asarray(theta), interpret=True)
    ub, mask = _prune_model(bm, qw, theta, prune_ops.PRUNE_TILE)
    np.testing.assert_array_equal(ub, np.asarray(ref_ub))
    np.testing.assert_array_equal(mask, np.asarray(ref_mask))


def test_the_wrappers_tile_is_one_the_kernel_takes():
    assert prune_ops.PRUNE_TILE in prune_ops.TILES
    with pytest.raises(ValueError, match="tile"):
        prune_ops.block_prune_launch(*(torch.zeros(s) for s in ((1, 2, 3), (1, 2), (1,))),
                                     tile=48)


# ---------------------------------------------------------------------------
# the launch path, through a stand-in library
# ---------------------------------------------------------------------------


def _c_signatures(source):
    """``{symbol: [ctypes type, ...]}`` of a source's ``extern "C"`` launchers."""
    text = (CSRC / source).read_text()
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
        sigs[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                      for p in (q.strip() for q in params.split(",")) if p]
    return sigs


_FnBase = ctypes.CFUNCTYPE(ctypes.c_int)


class _CountedSymbol(_FnBase):
    """A foreign function that counts how often its argument types are set."""
    _flags_ = _FnBase._flags_
    _restype_ = ctypes.c_int

    def __setattr__(self, name, value):
        if name == "argtypes":
            self.argtype_sets = getattr(self, "argtype_sets", 0) + 1
        super().__setattr__(name, value)


class _StubLibrary:
    """Stands in for a built kernel library: each launcher is a C-callable
    stub with the source's signature that records its arguments and returns
    ``code``."""

    def __init__(self, source, code=0):
        self.calls = {}
        self._keep = []
        for symbol, types in _c_signatures(source).items():
            calls = self.calls.setdefault(symbol, [])
            proto = ctypes.CFUNCTYPE(ctypes.c_int, *types)
            cb = proto(lambda *args, calls=calls: calls.append(args) or code)
            self._keep.append(cb)
            setattr(self, symbol, _CountedSymbol(ctypes.cast(cb, ctypes.c_void_p).value))


STREAM = 0x7A5C_0000_1000  # the stand-in current stream's handle


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _wrapper_launches():
    """Each launch entry: (kernel, symbol, call, tensors whose pointers lead
    its arguments, in order)."""
    i32 = torch.int32
    docs, c = _t(2, 1024, dtype=i32), _t(2, 1024)
    live = _t(1024, dtype=i32)
    bm, qw, th = _t(2, 5, 300), _t(2, 5), _t(2)
    bm_block, bm_weight = _t(40, dtype=i32), _t(40)
    base, cnt = _t(2, 5, dtype=i32), _t(2, 5, dtype=i32)
    scores = _t(2, 512)
    dt, dw, q_t = _t(2, 16, 8, dtype=i32), _t(2, 16, 8), _t(2, 5, dtype=i32)
    store_t, store_w, block_ids = _t(64, 8, dtype=i32), _t(64, 8), _t(2, 2, dtype=i32)
    ub, proc = _t(2, 4), _t(2, 4, dtype=torch.bool)
    ps, pi = _t(2, 3), _t(2, 3, dtype=i32)
    trips = _t(2, dtype=i32)
    chunk = (store_t, store_w, q_t, qw, ub, proc, ps, pi, th)
    kw = dict(block_budget=2, block_size=16, n_live=64)
    return {
        "impact_scatter": ("impact_scatter", "impact_scatter_launch",
                           lambda: scatter_ops.impact_scatter_launch(docs, c, 1024, 512),
                           (docs, c)),
        "block_prune": ("block_prune", "block_prune_launch",
                        lambda: prune_ops.block_prune_launch(bm, qw, th), (bm, qw, th)),
        "impact_scatter_topk": ("impact_scatter_topk", "impact_scatter_topk_launch",
                                lambda: fused_ops.impact_scatter_topk_launch(
                                    docs, c, 1024, 1000, 10, 512, live), (docs, c, live)),
        "block_prune_csr": ("block_prune_csr", "block_prune_csr_launch",
                            lambda: csr_ops.block_prune_csr_launch(
                                bm_block, bm_weight, base, cnt, qw, th, 300),
                            (bm_block, bm_weight, base, cnt, qw, th)),
        "block_topk": ("block_topk", "block_topk_launch",
                       lambda: btopk_ops.block_topk_launch(scores, 8, 256), (scores,)),
        "sparse_score": ("sparse_score", "sparse_score_launch",
                         lambda: score_ops.sparse_score_launch(dt, dw, q_t, qw), (dt, dw, q_t, qw)),
        "sparse_score_blocks": ("sparse_score", "sparse_score_blocks_launch",
                                lambda: score_ops.sparse_score_blocks_launch(
                                    store_t, store_w, block_ids, q_t, qw, block_size=32,
                                    n_live=60, live=live[:64]),
                                (store_t, store_w, block_ids, live[:64])),
        "chunk_step": ("chunk_step", "chunk_step_launch",
                       lambda: chunk_ops._launch(chunk, None, None, 1, **kw), (ub, proc)),
        "chunk_step_multi": ("chunk_step", "chunk_step_multi_launch",
                             lambda: chunk_ops._launch(chunk, None, trips, 3, **kw), (ub, proc)),
    }


@pytest.fixture
def stand_in(monkeypatch):
    """Stub libraries for every kernel, CPU tensors let through the device
    check, 132 SMs, and a stand-in current stream."""
    libs = {p.stem: _StubLibrary(p.name) for p in CSRC.glob("*.cu")}
    monkeypatch.setattr(common, "_LIBS", dict(libs))
    monkeypatch.setattr(common, "_LAUNCHERS", {})
    monkeypatch.setattr(common, "check_cuda_tensors", lambda *ts: None)
    monkeypatch.setattr(common, "sm_count", lambda device: N_SMS)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: STREAM + index + 1,
                        raising=False)
    return libs


@pytest.mark.parametrize("entry", list(_wrapper_launches()))
def test_every_wrapper_launches_through_the_bound_helper(stand_in, entry):
    """Two launches: the argument types are set once, equal to the C
    signature, the pointers arrive whole and in order, and the stream is the
    current stream's handle (of the tensors' device index, -1 on the CPU)."""
    name, symbol, call, lead = _wrapper_launches()[entry]
    lib = stand_in[name]
    call()
    call()
    fn = getattr(lib, symbol)
    assert fn.argtype_sets == 1
    assert list(fn.argtypes) == _c_signatures(f"{name}.cu")[symbol]
    calls = lib.calls[symbol]
    assert len(calls) == 2
    for args in calls:
        assert list(args[:len(lead)]) == [t.data_ptr() for t in lead]
        assert args[-1] == STREAM
    # other kernels' launchers were not touched
    assert all(not v for s, v in lib.calls.items() if s != symbol)


def test_pointers_and_the_stream_reach_the_symbol_whole(stand_in):
    """Values past 32 bits (a device pointer, a stream) and a null pointer
    arrive unchanged (an untyped argument would go as a 32-bit int)."""
    big, stream = 0x7FFF_DEAD_BEEF_0, STREAM
    common.launch("block_prune", "block_prune_launch", 5,
                  (big, big + 8, None, big + 24, big + 32, 2, 3, 4, 32), -1)
    args = stand_in["block_prune"].calls["block_prune_launch"][-1]
    assert args == (big, big + 8, None, big + 24, big + 32, 2, 3, 4, 32, stream)


def test_the_launcher_is_bound_once_per_loaded_library(stand_in, monkeypatch):
    first = common.launcher("block_topk", "block_topk_launch", 3, 7)
    assert common.launcher("block_topk", "block_topk_launch", 3, 7) is first
    monkeypatch.setitem(common._LIBS, "block_topk", _StubLibrary("block_topk.cu"))
    again = common.launcher("block_topk", "block_topk_launch", 3, 7)
    assert again is not first and again.argtype_sets == 1


def test_a_failed_launch_raises(monkeypatch, stand_in):
    monkeypatch.setitem(common._LIBS, "block_prune", _StubLibrary("block_prune.cu", code=9))
    with pytest.raises(RuntimeError, match="block_prune_launch failed to launch: cudaError 9"):
        prune_ops.block_prune_launch(_t(1, 2, 3), _t(1, 2), _t(1))


def test_no_wrapper_sets_argument_types_itself():
    """Every wrapper module launches through ``common.launch``."""
    kernels = Path(common.__file__).resolve().parent
    for ops in kernels.glob("*/ops.py"):
        text = ops.read_text()
        assert "argtypes" not in text and "ctypes" not in text, ops
        assert "common.launch(" in text, ops


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_scatter_kernel_matches_the_plain_version_at_the_edges(name, monkeypatch):
    dev = _cuda()
    for spt, stages in LAYOUTS:
        docs, c, n_docs = _edge_case(name, spt)
        want = _plain(docs, c, n_docs)
        monkeypatch.setattr(scatter_ops, "range_layout", lambda *a, lay=(spt, stages): lay)
        got = scatter_ops.impact_scatter_launch(torch.as_tensor(docs, device=dev),
                                                torch.as_tensor(c, device=dev), n_docs, 512)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=f"{name} {spt} {stages}")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,lq,nb", PRUNE_SHAPES)
def test_prune_kernel_matches_the_plain_version(batch, lq, nb):
    dev = _cuda()
    bm, qw, theta = _prune_inputs(batch, lq, nb, seed=lq * nb)
    want = block_prune_batched_ref(*(torch.as_tensor(a) for a in (bm, qw, theta)))
    args = tuple(torch.as_tensor(a, device=dev) for a in (bm, qw, theta))
    for tile in prune_ops.TILES:
        ub, mask = prune_ops.block_prune_launch(*args, tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(ub.cpu(), want[0]) and torch.equal(mask.cpu(), want[1]), tile


@pytest.mark.cuda
def test_stream_handle_is_the_current_stream():
    dev = _cuda()
    side = torch.cuda.Stream(dev)
    assert common.stream_handle(dev.index or 0) == torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.stream(side):
        assert common.stream_handle(torch.cuda.current_device()) == side.cuda_stream
