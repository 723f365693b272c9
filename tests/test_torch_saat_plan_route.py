"""The fused SAAT route that reads postings straight from the index through
the plan (``impact_scatter_topk_segments``), against the gathered route it
replaced, bit for bit.

The gathered route: ``_gather_postings_batched`` maps the first rho slots
of each row to (doc, contribution), ``sorted_posting_tiles`` sorts each row
stably by doc, ``impact_scatter_topk_block_ref`` sums, masks and keeps each
block's best, ``_merge_pool`` merges the pool. The segment entry's plain
version walks the plan's admitted segments instead and adds each one's
postings a column at a time. Both pools, and the merged scores and ids,
must be ``torch.equal``: rho cutting a segment, at and past a row's total,
the exact level, an all-pad row, pad slots, ties (``-inf`` ones included),
tombstones, a ragged doc count, B = 1; and the contract's synthetic plans.

On a card (marker ``cuda``; they skip here): the kernel against its plain
version, the exact level with no host read, and a fused server's dispatches
held to no host read by the hot-path lint. No JAX is imported, so
``pytest -m cuda --noconftest`` runs them there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.analysis import op_trace
from repro_torch.analysis.hot_path import NO_READS, lint_route, lint_server, query_batch
from repro_torch.core import build_impact_index, max_segments_per_term, saat_plan, saat_search
from repro_torch.core.saat import SaatPlan, _gather_postings_batched
from repro_torch.kernels import common
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops
from repro_torch.kernels.impact_scatter_topk.ref import (
    impact_scatter_topk_block_ref,
    impact_scatter_topk_segments_ref,
)

pytestmark = pytest.mark.torch_port

BLOCK_D = 512


def _corpus_index(n_docs, n_terms, terms_a_doc, levels=None, seed=0, device="cpu"):
    """A random index: ``terms_a_doc`` distinct terms a doc, weights from a
    gamma law, or drawn from ``levels`` (few impacts: many tied scores)."""
    rng = np.random.default_rng(seed)
    doc = np.repeat(np.arange(n_docs), terms_a_doc)
    term = np.concatenate([rng.choice(n_terms, terms_a_doc, replace=False) for _ in range(n_docs)])
    w = rng.gamma(2.0, 1.0, doc.size) if levels is None else rng.choice(levels, doc.size)
    return build_impact_index(doc, term, w.astype(np.float32), n_docs, n_terms, device=device)


def _queries(index, B, lq, n_pad=0, seed=1, equal=False):
    """``[B, lq + n_pad]`` queries: ``lq`` distinct terms, then pad slots
    (weight 0); ``equal`` gives every term weight 1."""
    rng = np.random.default_rng(seed)
    qt = np.stack([rng.choice(index.n_terms, lq + n_pad, replace=False) for _ in range(B)])
    qw = np.ones((B, lq)) if equal else rng.uniform(0.2, 2.0, (B, lq))
    qw = np.concatenate([qw, np.zeros((B, n_pad))], axis=1)
    return torch.as_tensor(qt, dtype=torch.int32), torch.as_tensor(qw, dtype=torch.float32)


def _padded_live(live, n_docs_pad):
    if live is None:
        return None
    return common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()


def gathered_pool(doc_ids, plan, rho, n_docs, n_live, k, live=None):
    """The replaced route on a plan: ``(pool, (scores, ids))``."""
    holder = type("Store", (), {"doc_ids": doc_ids})
    if rho >= doc_ids.shape[0]:
        rho = min(rho, max(1, int(plan.total_postings.max())))
    docs, contribs, _ = _gather_postings_batched(holder, plan, rho)
    n_docs_pad = common.round_up(max(n_docs, BLOCK_D), BLOCK_D)
    k_out = min(k, n_docs)
    d, c = common.sorted_posting_tiles(docs, contribs, n_docs_pad, 512)
    pool = impact_scatter_topk_block_ref(d, c, n_docs_pad, min(n_live, n_docs), min(k_out, BLOCK_D),
                                         BLOCK_D, _padded_live(live, n_docs_pad))
    return pool, fused_ops._merge_pool(*pool, k_out)


def segment_pool(doc_ids, plan, rho, n_docs, n_live, k, live=None):
    """The segment entry on the same plan: ``(pool, (scores, ids))``."""
    n_docs_pad = common.round_up(max(n_docs, BLOCK_D), BLOCK_D)
    k_out = min(k, n_docs)
    pool = impact_scatter_topk_segments_ref(
        doc_ids, plan.starts, plan.contribs, plan.cum_len, min(rho, 2**31 - 1), n_docs_pad,
        min(n_live, n_docs), min(k_out, BLOCK_D), BLOCK_D, _padded_live(live, n_docs_pad))
    merged = fused_ops.impact_scatter_topk_segments(
        doc_ids, plan.starts, plan.contribs, plan.cum_len, rho, n_docs, k, n_live=n_live,
        live=live)
    return pool, merged


def _assert_equal(got, want):
    (gs, gi), (ms, mi) = got
    (ws, wi), (ns, ni) = want
    for a, b in ((gs, ws), (gi, wi), (ms, ns), (mi, ni)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


def _mid_rho(plan):
    """Half-way into the first row's longest admitted segment."""
    cum = plan.cum_len[0].long()
    lens = torch.diff(cum, prepend=cum.new_zeros(1))
    j = int(torch.argmax(lens))
    return int(cum[j] - lens[j] // 2)


# (case, corpus, queries, rho, k, tombstones)
CASES = {
    "rho_mid_segment": (dict(), dict(), "mid", 10, False),
    "rho_at_a_total": (dict(), dict(), "total", 10, False),
    "rho_past_every_total": (dict(), dict(), "beyond", 10, False),
    "exact_level": (dict(), dict(), "exact", 10, False),
    "all_pad_row": (dict(), dict(pad_row=True), "mid", 10, False),
    "pad_slots": (dict(), dict(n_pad=5), 3000, 10, False),
    "tied_scores": (dict(levels=(1.0, 2.0)), dict(equal=True), "exact", 40, False),
    "neg_inf_ties": (dict(n_docs=40, terms_a_doc=4), dict(), "exact", 600, True),
    "tombstones": (dict(), dict(), "mid", 25, True),
    "n_docs_ragged_k_past_select": (dict(n_docs=1300), dict(), 5000, 33, True),
    "batch_of_one": (dict(), dict(B=1), "mid", 10, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_route_equals_gathered_route(case):
    corpus, qkw, rho, k, tomb = CASES[case]
    corpus = dict(dict(n_docs=1000, n_terms=80, terms_a_doc=12), **corpus)
    index = _corpus_index(**corpus)
    qkw = dict(qkw)
    pad_row = qkw.pop("pad_row", False)
    qt, qw = _queries(index, **dict(dict(B=4, lq=6), **qkw))
    if pad_row:
        qw[1] = 0.0
    plan = saat_plan(index, qt, qw, max_segments_per_term(index))
    totals = plan.total_postings
    rho = {"mid": lambda: _mid_rho(plan), "total": lambda: int(totals.sort().values[1]),
           "beyond": lambda: int(totals.max()) + 7,
           "exact": lambda: index.n_postings}.get(rho, lambda: rho)()
    if case == "rho_at_a_total":
        assert int(totals.min()) < rho < int(totals.max())  # a row past it, one at, one cut
    live = None
    if tomb:
        live = torch.as_tensor(np.random.default_rng(3).random(index.n_docs) < 0.7,
                               dtype=torch.int32)
        live = common.pad_axis(live, 0, index.doc_terms.shape[0])
    args = (index.doc_ids, plan, rho, index.doc_terms.shape[0], index.n_docs, k, live)
    got, want = segment_pool(*args), gathered_pool(*args)
    _assert_equal(got, want)
    if case == "neg_inf_ties":
        assert bool(torch.isinf(got[1][0]).any())
    if case == "tied_scores":
        s = got[1][0]
        assert bool((s[:, 1:] == s[:, :-1]).any())
    res = saat_search(index, qt, qw, k=k, rho=rho, max_segs_per_term=max_segments_per_term(index),
                      fused_topk=True, live_mask=live)
    assert torch.equal(res.scores, want[1][0]) and torch.equal(res.doc_ids, want[1][1])
    assert torch.equal(res.postings_processed, torch.clamp_max(totals, rho))


@pytest.mark.parametrize("name", [n for n, _ in fused_ops.SEGMENT_CASES])
def test_segment_contract_cases_equal_gathered_route(name):
    """The contract's synthetic plans (repeated segments, pad columns, both
    block_d edges, several CTA ranges) at the case's own block_d."""
    dims = dict(fused_ops.SEGMENT_CASES)[name]
    doc_ids, starts, contribs, cum = fused_ops.segment_plan_inputs(dims, "cpu")
    fn, _ = fused_ops.CONTRACT.make_call(dims, "cpu")
    rho, live, n, block_d = fn.keywords["rho"], fn.keywords["live"], dims["n_docs"], dims["block_d"]
    n_docs_pad = common.round_up(max(n, block_d), block_d)
    k_blk = min(dims["k"], n, block_d)
    live_pad = _padded_live(live, n_docs_pad)
    pool = impact_scatter_topk_segments_ref(doc_ids, starts, contribs, cum, rho, n_docs_pad, n,
                                            k_blk, block_d, live_pad)
    holder = type("Store", (), {"doc_ids": doc_ids})
    plan = SaatPlan(starts, contribs, cum, cum[:, -1])
    docs, c, _ = _gather_postings_batched(holder, plan, min(rho, int(cum[:, -1].max())))
    d, cc = common.sorted_posting_tiles(docs, c, n_docs_pad, 512)
    want = impact_scatter_topk_block_ref(d, cc, n_docs_pad, n, k_blk, block_d, live_pad)
    assert torch.equal(pool[0], want[0]) and torch.equal(pool[1], want[1])
    got_s, got_i = fn(doc_ids, starts, contribs, cum)
    want_s, want_i = fused_ops._merge_pool(*want, min(dims["k"], n))
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)


def test_segment_layout_covers_and_fits():
    for n_docs in (64, 1024, 1536, 276_480):
        lay = fused_ops.segments_layout(n_docs)
        assert lay["cta_docs"] % lay["threads"] == 0 and lay["threads"] % 32 == 0
        assert lay["cta_docs"] <= 65_536 and lay["smem"] <= common.SMEM_LIMIT
    lay = fused_ops.segments_layout(276_480)
    assert (lay["cta_docs"], lay["threads"], lay["stage"]) == (8192, 512, 8192)
    plan = fused_ops.segments_launch_plan(32, 9861, 1_000_000, 276_480, 276_307, 10, 512)
    assert plan.grid == (34, 32, 1)


# --------------------------------------------------------------------------
# on a card
# --------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc to build and launch the kernel")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in fused_ops.SEGMENT_CASES])
def test_segment_kernel_equals_its_plain_version(name):
    dev = _cuda()
    dims = dict(fused_ops.SEGMENT_CASES)[name]
    fn, args = fused_ops.CONTRACT.make_call(dims, dev)
    n_docs_pad = common.round_up(max(dims["n_docs"], dims["block_d"]), dims["block_d"])
    k_blk = min(dims["k"], dims["n_docs"], dims["block_d"])
    live = _padded_live(fn.keywords["live"], n_docs_pad)
    before = fused_ops.PLAN_LAUNCHES
    got = fused_ops.impact_scatter_topk_segments_launch(
        *args, fn.keywords["rho"], n_docs_pad, dims["n_docs"], k_blk, dims["block_d"], live)
    want = impact_scatter_topk_segments_ref(*(a.cpu() for a in args), fn.keywords["rho"],
                                            n_docs_pad, dims["n_docs"], k_blk, dims["block_d"],
                                            None if live is None else live.cpu())
    torch.cuda.synchronize()
    assert fused_ops.PLAN_LAUNCHES == before + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_fused_route_on_a_card_reads_nothing_at_the_exact_level():
    dev = _cuda()
    index = _corpus_index(3000, 120, 20, device=dev)
    qt, qw = _queries(index, 8, 10, n_pad=3)
    qt, qw = qt.to(dev), qw.to(dev)
    ms = max_segments_per_term(index)
    run = lambda qt, qw: saat_search(index, qt, qw, k=10, rho=index.n_postings,  # noqa: E731
                                     max_segs_per_term=ms, fused_topk=True)
    run(qt, qw)
    before = (fused_ops.PLAN_LAUNCHES, fused_ops.LAUNCHES)
    trace = op_trace.record(run, qt, qw, sync_debug="error")
    assert trace.reads() == [] and trace.sync_warnings is None
    assert [op.name for op in op_trace.find_kernel_calls(trace)] == \
        ["kernel:impact_scatter_topk_segments"]
    assert (fused_ops.PLAN_LAUNCHES, fused_ops.LAUNCHES) == (before[0] + 1, before[1])
    cpu = index.to("cpu")
    want = saat_search(cpu, qt.cpu(), qw.cpu(), k=10, rho=cpu.n_postings,
                       max_segs_per_term=ms, fused_topk=True)
    assert torch.equal(trace.result.scores.cpu(), want.scores)
    assert torch.equal(trace.result.doc_ids.cpu(), want.doc_ids)


@pytest.mark.cuda
def test_fused_server_on_a_card_lints_with_no_host_read():
    from repro_torch.serving.scheduler import AnytimeServer, ServingConfig

    dev = _cuda()
    index = _corpus_index(3000, 120, 20, device=dev)
    server = AnytimeServer(index, ServingConfig(engine="saat", k=5, rho_ladder=(2000, 20000),
                                                lq_buckets=(4, 8), fused_topk=True))
    assert lint_server(server, batch_sizes=(2, 4)) == []
    args = query_batch(4, 8, index.n_terms, dev)
    for rho in server.rho_ladder:  # the exact level among them
        violations, trace = lint_route(server.engine_fn(rho), args, "fused", f"rho={rho}",
                                       NO_READS)
        assert violations == [] and trace.reads() == [] and trace.sync_warnings == 0
    assert server.rho_ladder[-1] >= index.n_postings
