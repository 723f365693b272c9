#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

It needs one CUDA card and exits non-zero without one. In order:

1. builds every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build time and the compiler's register report;
2. generates one shard of a 32-way document-sharded MS MARCO passage
   deployment (276,307 docs, 256 queries) under the ``spladev2`` and
   ``bm25`` treatments, builds each impact index on the host and places it
   on the card;
3. kernel phases: each kernel, and each single-query (B=1) wrapper, at the
   reference's contract shapes and at the main path's shapes (with and
   without a tombstone bitmap), held against its plain PyTorch version on
   the card (ids equal, scores within rtol 1e-5 / atol 1e-6) and timed with
   CUDA events beside the plain version and a library yardstick;
4. main path: after one warm-up batch per configuration, serves the 256
   queries in batches of 64 through ``saat_search`` with the fused kernel
   and with the scatter kernel, at k=10 for rho in {100k, 1M, exact} and at
   k=1000 for rho=1M, with the launch counters set to 0 just before and
   read just after;
5. holds every result against the plain ``"sort"`` mode on the card, and
   the exact-rho results against ``exhaustive_search``;
6. prints RR@10, batch latencies (median and max), a profiled batch, the
   card's name and power limit, one
   ``{"kernels": [...]}`` JSON line, and last the ``{"ok": true, ...}`` line.

Any mismatch raises, so the run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    build_impact_index,
    exhaustive_search,
    max_segments_per_term,
    pad_queries,
    saat_plan,
    saat_search,
)
from repro_torch.core.saat import _gather_postings_batched  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, generate_corpus  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.impact_scatter import ops as scatter_ops  # noqa: E402
from repro_torch.kernels.impact_scatter import ref as scatter_ref  # noqa: E402
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops  # noqa: E402
from repro_torch.kernels.impact_scatter_topk import ref as fused_ref  # noqa: E402
from repro_torch.metrics.ir_metrics import mrr_at_k  # noqa: E402
from repro_torch.models.treatments import apply_treatment  # noqa: E402

# MS MARCO passage v1 holds 8,841,823 passages; one shard of 32.
N_DOCS = 276_307
N_QUERIES = 256
BATCH = 64
TREATMENTS = ("spladev2", "bm25")
RUNS = ((10, 100_000), (10, 1_000_000), (10, "exact"), (1000, 1_000_000))
MAIN_SHAPE = ("spladev2", 10, 1_000_000)  # the (treatment, k, rho) the kernels line reports
RTOL, ATOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate

# The reference kernels' CONTRACT.shape_grid (src/repro/kernels/*/ops.py),
# copied: this script imports nothing of the JAX package.
SCATTER_CASES = (
    ("single_tile", dict(n_postings=128, n_docs=512, block_d=256, tile_p=128)),
    ("ragged", dict(n_postings=1000, n_docs=1000, block_d=256, tile_p=128)),
    ("multi_tile", dict(n_postings=4096, n_docs=512, block_d=256, tile_p=128)),
    ("b1", dict(batch=1, n_postings=128, n_docs=700, block_d=256, tile_p=128)),
    ("b3_ragged", dict(batch=3, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
    ("b8", dict(batch=8, n_postings=1000, n_docs=700, block_d=256, tile_p=128)),
)
TOPK_CASES = (
    ("k1", dict(n_postings=128, n_docs=512, k=1, block_d=256, tile_p=128)),
    ("k10_ragged", dict(n_postings=1000, n_docs=1000, k=10, block_d=256, tile_p=128)),
    ("k300", dict(n_postings=4096, n_docs=512, k=300, block_d=256, tile_p=128)),
    ("live_ragged", dict(n_postings=1000, n_docs=1000, k=10, block_d=256, tile_p=128, live=1)),
    ("b1", dict(batch=1, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128)),
    ("b3_ragged", dict(batch=3, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128)),
    ("b8", dict(batch=8, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128)),
    ("b3_live", dict(batch=3, n_postings=1000, n_docs=700, k=13, block_d=256, tile_p=128, live=1)),
)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Scores agree within RTOL/ATOL (-inf where and only where the plain
    version has -inf). Returns the largest absolute difference."""
    got, want = got.float().cpu(), want.float().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()), f"{what}: -inf pattern differs")
    if not bool(fin.any()):
        return 0.0
    diff = (got[fin] - want[fin]).abs()
    bad = diff > ATOL + RTOL * want[fin].abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} scores off, max diff {float(diff.max())}")
    return float(diff.max())


def ids_equal(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    check(torch.equal(got.cpu().long(), want.cpu().long()), f"{what}: ids differ")


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phases: each kernel against its plain version
#
# The plain version that decides correctness runs on a host copy of the
# kernel's inputs: there ``index_add_`` adds each doc's contributions in row
# order, as the kernel does, so ids must match exactly (and scores come out
# bit-equal). On the card ``index_add_`` adds in another order, which can
# swap docs whose sums differ in the last bit; it is timed there (plain_ms).
# ---------------------------------------------------------------------------


def case_inputs(dims: dict, seed: int, device: torch.device):
    """Inputs of one contract shape, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    shape = (dims.get("batch", 1), dims["n_postings"])
    docs = torch.as_tensor(rng.integers(0, dims["n_docs"], shape), dtype=torch.int32, device=device)
    contribs = torch.as_tensor(rng.gamma(2.0, 1.0, shape), dtype=torch.float32, device=device)
    live = None
    if dims.get("live"):
        live = torch.as_tensor(rng.random(dims["n_docs"]) < 0.8, dtype=torch.int32, device=device)
    return docs, contribs, live


def scatter_phase(docs_raw, contribs_raw, n_docs, block_d, tile_p, single, timed, what):
    """impact_scatter: kernel vs plain on sorted inputs, and the wrapper."""
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    docs, c = common.sorted_posting_tiles(docs_raw, contribs_raw, n_docs_pad, tile_p)
    got = scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d)
    want = scatter_ref.impact_scatter_batched_ref(docs.cpu(), c.cpu(), n_docs_pad)
    sync()
    err = max_err(got, want, f"impact_scatter {what}")
    if single:
        wrapped = scatter_ops.impact_scatter(docs_raw[0], contribs_raw[0], n_docs,
                                             block_d=block_d, tile_p=tile_p)[None]
    else:
        wrapped = scatter_ops.impact_scatter_batched(docs_raw, contribs_raw, n_docs,
                                                     block_d=block_d, tile_p=tile_p)
    err = max(err, max_err(wrapped, want[:, :n_docs], f"impact_scatter wrapper {what}"))
    row = {"what": what, "max_abs_err": err}
    if timed:
        B = docs.shape[0]
        n_real = int((docs < n_docs_pad).sum())
        docs_long = docs.long()
        row.update(
            ms=cuda_ms(lambda: scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d)),
            plain_ms=cuda_ms(lambda: scatter_ref.impact_scatter_batched_ref(docs, c, n_docs_pad)),
            library_ms=cuda_ms(lambda: torch.zeros(
                (B, n_docs_pad + 1), device=docs.device).scatter_add_(1, docs_long, c)),
            bound_ms=1e3 * (8 * n_real + 4 * B * n_docs_pad) / HBM_BYTES_PER_S,
            postings=n_real, shape=[B, int(docs.shape[1]), n_docs_pad],
        )
    return row


def topk_phase(docs_raw, contribs_raw, n_docs, k, block_d, tile_p, live, single, timed, what):
    """impact_scatter_topk: kernel vs plain per-block pools, and the wrapper."""
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    k_out = min(k, n_docs)
    k_blk = min(k_out, block_d)
    docs, c = common.sorted_posting_tiles(docs_raw, contribs_raw, n_docs_pad, tile_p)
    live_pad = None
    if live is not None:
        live_pad = common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()
    gs, gi = fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_docs, k_blk, block_d, live_pad)
    ws, wi = fused_ref.impact_scatter_topk_block_ref(
        docs.cpu(), c.cpu(), n_docs_pad, n_docs, k_blk, block_d,
        None if live_pad is None else live_pad.cpu())
    sync()
    ids_equal(gi, wi, f"impact_scatter_topk {what}")
    err = max_err(gs, ws, f"impact_scatter_topk {what}")
    if single:
        s, i = fused_ops.impact_scatter_topk(docs_raw[0], contribs_raw[0], n_docs, k, live=live,
                                             block_d=block_d, tile_p=tile_p)
        s, i = s[None], i[None]
    else:
        s, i = fused_ops.impact_scatter_topk_batched(docs_raw, contribs_raw, n_docs, k, live=live,
                                                     block_d=block_d, tile_p=tile_p)
    # the wrapper against the plain dense pipeline: scatter, mask, top-k
    dense = scatter_ref.impact_scatter_batched_ref(docs.cpu(), c.cpu(), n_docs_pad)[:, :n_docs]
    if live is not None:
        dense = torch.where(live[:n_docs].cpu() != 0, dense, float("-inf"))
    want_s, want_i = torch.sort(dense, dim=-1, descending=True, stable=True)
    ids_equal(i, want_i[:, :k_out], f"impact_scatter_topk wrapper {what}")
    err = max(err, max_err(s, want_s[:, :k_out], f"impact_scatter_topk wrapper {what}"))
    row = {"what": what, "max_abs_err": err}
    if timed:
        B = docs.shape[0]
        nb = n_docs_pad // block_d
        n_real = int((docs < n_docs_pad).sum())
        docs_long = docs.long()
        keep = torch.arange(n_docs_pad, device=docs.device) < n_docs
        if live_pad is not None:
            keep = keep & (live_pad != 0)

        def library():
            acc = torch.zeros((B, n_docs_pad + 1), device=docs.device).scatter_add_(1, docs_long, c)
            acc = torch.where(keep, acc[:, :n_docs_pad], float("-inf"))
            return torch.topk(acc.view(B, nb, block_d), k_blk)

        row.update(
            ms=cuda_ms(lambda: fused_ops.impact_scatter_topk_launch(
                docs, c, n_docs_pad, n_docs, k_blk, block_d, live_pad)),
            plain_ms=cuda_ms(lambda: fused_ref.impact_scatter_topk_block_ref(
                docs, c, n_docs_pad, n_docs, k_blk, block_d, live_pad)),
            library_ms=cuda_ms(library),
            bound_ms=1e3 * (8 * n_real + (4 * n_docs_pad if live_pad is not None else 0)
                            + 8 * B * nb * k_blk) / HBM_BYTES_PER_S,
            postings=n_real, shape=[B, int(docs.shape[1]), n_docs_pad, k_blk],
        )
    return row


def contract_phases(device, seed) -> tuple[float, float]:
    """Every kernel and B=1 wrapper at the reference's contract shapes."""
    errs = {"impact_scatter": 0.0, "impact_scatter_topk": 0.0}
    for i, (name, dims) in enumerate(SCATTER_CASES):
        docs, contribs, _ = case_inputs(dims, seed + i, device)
        row = scatter_phase(docs, contribs, dims["n_docs"], dims["block_d"], dims["tile_p"],
                            single="batch" not in dims, timed=False, what=f"contract {name}")
        errs["impact_scatter"] = max(errs["impact_scatter"], row["max_abs_err"])
    for i, (name, dims) in enumerate(TOPK_CASES):
        docs, contribs, live = case_inputs(dims, seed + 100 + i, device)
        row = topk_phase(docs, contribs, dims["n_docs"], dims["k"], dims["block_d"],
                         dims["tile_p"], live, single="batch" not in dims, timed=False,
                         what=f"contract {name}")
        errs["impact_scatter_topk"] = max(errs["impact_scatter_topk"], row["max_abs_err"])
    print(f"contract phases: {len(SCATTER_CASES)} impact_scatter and {len(TOPK_CASES)} "
          f"impact_scatter_topk shapes agree with their plain versions; max abs err {errs}")
    return errs["impact_scatter"], errs["impact_scatter_topk"]


def main_shape_phases(index, qt, qw, live) -> dict:
    """Both kernels at the main path's shapes: one batch at rho = 1M."""
    ms = max_segments_per_term(index)
    n_docs_pad = index.doc_terms.shape[0]
    plan = saat_plan(index, qt, qw, ms)
    docs, contribs, _ = _gather_postings_batched(index, plan, 1_000_000)
    B = docs.shape[0]
    rows = {"impact_scatter": [], "impact_scatter_topk": []}
    rows["impact_scatter"].append(scatter_phase(
        docs, contribs, n_docs_pad, 512, 512, single=False, timed=True, what=f"main B={B} rho=1M"))
    rows["impact_scatter"].append(scatter_phase(
        docs[:1], contribs[:1], n_docs_pad, 512, 512, single=True, timed=True,
        what="main B=1 rho=1M"))
    for k in (10, 1000):
        for lv in (None, live):
            tag = f"main B={B} rho=1M k={k}{' live' if lv is not None else ''}"
            rows["impact_scatter_topk"].append(topk_phase(
                docs, contribs, index.n_docs, k, 512, 512, lv, single=False, timed=True, what=tag))
    rows["impact_scatter_topk"].append(topk_phase(
        docs[:1], contribs[:1], index.n_docs, 10, 512, 512, None, single=True, timed=True,
        what="main B=1 rho=1M k=10"))
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['what']}: " + json.dumps({k: v for k, v in r.items() if k != "what"}))
    return rows


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def make_data(n_docs, n_queries, seed, device):
    t0 = time.perf_counter()
    corpus = generate_corpus(CorpusConfig(n_docs=n_docs, n_queries=n_queries, seed=seed))
    print(f"corpus: {n_docs} docs, {n_queries} queries in {time.perf_counter() - t0:.1f} s (host)")
    data = {}
    for m in TREATMENTS:
        t0 = time.perf_counter()
        enc = apply_treatment(corpus, m, seed=seed)
        index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, corpus.n_docs,
                                   enc.n_terms, device=device)
        max_q = max(len(t) for t in enc.query_terms)
        qt, qw = pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)
        sync()
        print(f"{m}: {index.n_postings} postings, {enc.n_terms} terms, Lq {max_q}, "
              f"Tmax {index.max_doc_terms}, index {index.nbytes() / 1e9:.3f} GB on {device}, "
              f"built in {time.perf_counter() - t0:.1f} s")
        data[m] = (index, torch.as_tensor(qt, device=device), torch.as_tensor(qw, device=device))
    return corpus, data


def serve(data, n_batches=None):
    """The main path: every batch (or the first ``n_batches``) through both
    kernel routes. Returns the results and, per configuration, the batch
    latencies in ms (host clock)."""
    results, latency = {}, {}
    for m, (index, qt, qw) in data.items():
        ms = max_segments_per_term(index)
        for lo in range(0, qt.shape[0], BATCH)[:n_batches]:
            bt, bw = qt[lo:lo + BATCH], qw[lo:lo + BATCH]
            exact = int(saat_plan(index, bt, bw, ms).total_postings.max())
            for k, rho in RUNS:
                r = exact if rho == "exact" else rho
                for route, kw in (("fused", dict(fused_topk=True)),
                                  ("kernel", dict(scatter_impl="kernel"))):
                    sync()
                    t0 = time.perf_counter()
                    res = saat_search(index, bt, bw, k=k, rho=r, max_segs_per_term=ms, **kw)
                    sync()
                    dt = 1e3 * (time.perf_counter() - t0)
                    results[(m, k, rho, route, lo)] = (res, r)
                    latency.setdefault((m, k, rho, route), []).append(dt)
    return results, latency


def tie_swaps(got_s, got_i, want_s, want_i, what) -> int:
    """Scores agree rank by rank within tolerance, so where the ids differ
    at a rank the two docs' scores agree within tolerance too: a near-tie
    that summation order may break either way. Returns how many ranks."""
    max_err(got_s, want_s, what)
    return int((got_i.cpu() != want_i.cpu()).sum())


def verify(data, results, qrels) -> dict:
    """Every served result against the plain "sort" mode on the card, and
    the exact-rho results against the exhaustive oracle."""
    rr, swaps = {}, 0
    for m, (index, qt, qw) in data.items():
        ms = max_segments_per_term(index)
        for k, rho in RUNS:
            ids_all = []
            for lo in range(0, qt.shape[0], BATCH):
                bt, bw = qt[lo:lo + BATCH], qw[lo:lo + BATCH]
                r = results[(m, k, rho, "fused", lo)][1]
                plain = saat_search(index, bt, bw, k=k, rho=r, max_segs_per_term=ms,
                                    scatter_impl="sort")
                oracle = exhaustive_search(index, bt, bw, k=k) if rho == "exact" else None
                for route in ("fused", "kernel"):
                    res = results[(m, k, rho, route, lo)][0]
                    what = f"{m} k={k} rho={rho} {route} batch@{lo}"
                    check(torch.equal(res.postings_processed, plain.postings_processed)
                          and torch.equal(res.total_postings, plain.total_postings),
                          f"{what}: posting counts differ from the sort mode")
                    swaps += tie_swaps(res.scores, res.doc_ids, plain.scores, plain.doc_ids,
                                       f"{what} vs sort")
                    if oracle is not None:
                        swaps += tie_swaps(res.scores, res.doc_ids, oracle.scores,
                                           oracle.doc_ids, f"{what} vs exhaustive")
                ids_all.append(results[(m, k, rho, "fused", lo)][0].doc_ids.cpu().numpy())
            rr[f"{m} k={k} rho={rho}"] = mrr_at_k(np.concatenate(ids_all), qrels, 10)
    print(f"verify: every result agrees with the plain sort mode (and exhaustive at exact rho); "
          f"{swaps} ranks differ in id between near-tied scores")
    return rr


def profile_batch(index, bt, bw, k, rho) -> None:
    """One fused batch under ``torch.profiler``: device time by kernel and
    by the PyTorch operator that launched it, and the device's busy share
    of the batch's (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ms = max_segments_per_term(index)
    saat_search(index, bt, bw, k=k, rho=rho, max_segs_per_term=ms, fused_topk=True)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        saat_search(index, bt, bw, k=k, rho=rho, max_segs_per_term=ms, fused_topk=True)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile spladev2 k={k} rho={rho} fused B={bt.shape[0]}: profiled wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%)")
    for what, events in (("operator", ops), ("kernel", kernels)):
        for e in events[:8]:
            print(f"  {what} {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:80]}")


def run(args, device) -> None:
    t_start = time.perf_counter()
    card = gpu_name_and_limit()
    print(card)
    t0 = time.perf_counter()
    logs = common.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    err_s, err_t = contract_phases(device, args.seed)
    corpus, data = make_data(args.n_docs, args.n_queries, args.seed, device)
    index, qt, qw = data[MAIN_SHAPE[0]]
    rng = np.random.default_rng(args.seed)
    live = torch.as_tensor(rng.random(index.doc_terms.shape[0]) < 0.9, dtype=torch.int32,
                           device=device)
    rows = main_shape_phases(index, qt[:BATCH], qw[:BATCH], live)

    serve(data, n_batches=1)  # warm-up: allocator and sort workspaces at every shape
    scatter_ops.LAUNCHES = 0
    fused_ops.LAUNCHES = 0
    results, latency = serve(data)
    launches = {"impact_scatter": scatter_ops.LAUNCHES, "impact_scatter_topk": fused_ops.LAUNCHES}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    rr = verify(data, results, corpus.qrels)
    for key, v in rr.items():
        print(f"RR@10 {key}: {v:.4f}")
    for (m, k, rho, route), v in latency.items():
        print(f"batch latency {m} k={k} rho={rho} {route}: median {np.median(v):.3f} ms, "
              f"max {max(v):.3f} ms over {len(v)} batches (B={BATCH}, host clock)")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    profile_batch(index, qt[:BATCH], qw[:BATCH], MAIN_SHAPE[1], MAIN_SHAPE[2])

    main = {"impact_scatter": rows["impact_scatter"][0], "impact_scatter_topk": rows["impact_scatter_topk"][0]}
    errs = {
        "impact_scatter": max([err_s] + [r["max_abs_err"] for r in rows["impact_scatter"]]),
        "impact_scatter_topk": max([err_t] + [r["max_abs_err"] for r in rows["impact_scatter_topk"]]),
    }
    meta = {
        "impact_scatter": ("src/repro_torch/csrc/impact_scatter.cu",
                           "src/repro/kernels/impact_scatter/kernel.py:83"),
        "impact_scatter_topk": ("src/repro_torch/csrc/impact_scatter_topk.cu",
                                "src/repro/kernels/impact_scatter_topk/kernel.py:229"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name], "ms": main[name]["ms"],
         "plain_ms": main[name]["plain_ms"], "bound_ms": main[name]["bound_ms"],
         "bound_by": "bytes", "library_ms": main[name]["library_ms"]}
        for name, (src, rep) in meta.items()
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the corpus and every input")
    ap.add_argument("--n-docs", type=int, default=N_DOCS, help="a smaller shard for a quick check")
    ap.add_argument("--n-queries", type=int, default=N_QUERIES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args, torch.device("cuda"))


if __name__ == "__main__":
    main()
