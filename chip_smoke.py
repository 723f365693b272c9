#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

It needs one CUDA card and exits non-zero without one. In order:

1. builds every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``, sm_90a,
   one process per source, all at once) and prints the build time and the
   compiler's register report;
2. kernel phases at the reference's contract shapes: each kernel, and each
   single-query (B=1) wrapper, held against its plain PyTorch version run
   on a host copy of its inputs; both scatter kernels bit for bit at their
   edges (an empty block, a range over three shared-memory stages, a block
   of tombstoned docs, pad docs, tied scores, k_blk = 1, 10, 16, 32, 33 and
   512 across the select-or-sort rule);
3. generates one shard of a 32-way document-sharded MS MARCO passage
   deployment (276,307 docs, 256 queries) under the ``spladev2`` and
   ``bm25`` treatments, builds each impact index on the host and places it
   on the card;
4. kernel phases at the main paths' shapes (one 64-query ``spladev2``
   batch; with and without a tombstone bitmap), held against the plain
   versions as above and timed with CUDA events beside the plain version
   and a library yardstick where one PyTorch call computes the same; the
   kernel and the yardstick also as 50 calls replayed from one CUDA graph,
   which leaves out the host's launch cost; ``block_topk`` and
   ``chunk_step`` also at their edges (ties, all--inf rows, ragged widths,
   B = 1 and 63, k = 1000, tombstones, rows that leave a multi-trip launch
   at different trips); ``sparse_score``'s store-addressed entry at the
   split trip's shape and phase 1's, and bit for bit at its edges (integer
   weights: B = 1 and 63, tombstones, the ragged last block, rows with no
   padding or no terms, duplicate query terms, the live-block gate), with a
   sweep of its docs per CTA and a check that a split batch scores through
   it and makes no [B, N, Tmax] gather; ``impact_scatter_topk``'s select
   and sort timed against each other at k_blk = 1 to 64;
5. the SAAT path: after one warm-up batch per configuration, serves the
   256 queries in batches of 64 through ``saat_search`` with the fused
   kernel and with the scatter kernel, at k=10 for rho in {100k, 1M,
   exact} and at k=1000 for rho=1M, and holds every result against the
   plain ``"sort"`` mode on the card (and ``exhaustive_search`` at exact
   rho); prints RR@10, batch latencies and a profiled batch;
6. the DAAT path: the same batches through ``daat_search_batched`` in the
   plain, split (``use_kernels``), fused (``fused_chunk``) and multi-trip
   (``trips_per_launch=8``) modes at (k=10, exact), (k=10, approximate)
   and (k=1000, exact), and one batch under the tombstone bitmap; the
   kernel modes must agree exactly, the plain mode within tolerance and
   with equal ``WorkStats`` (but at near-ties, printed), and exact results
   must be rank-safe and match ``exhaustive_search``; prints the work
   counts, batch latencies, host syncs and a profiled batch;
7. the dense ``block_prune`` on its oracle path: at the reference's
   contract shapes against its plain version, then on one 64-query
   ``spladev2`` batch ``_dense_blockmax_rows`` and the kernel, with theta
   the batch's DAAT k-th scores, ub equal bit for bit to ``block_prune_csr``
   and to the plain version; timed beside the plain version and
   ``torch.bmm``;
8. serving on the ``spladev2`` shard: ``AnytimeServer`` directly (SAAT,
   fused kernel, the CLI's rho ladder, a deadline under the top level's
   calibrated cost, every batch equal to ``saat_search`` at the rho served,
   the ``--eval-qrels`` sweep); through the admission queue on a
   ``HybridClock`` at the CLI's defaults (1,024 Poisson arrivals, each
   completion equal to ``saat_search`` on its flush); DAAT served in the
   fused and 8-trip modes (equal to ``daat_search_batched``); an
   ``IndexHandle`` under ``replay_with_churn`` with one compaction (answers
   equal across it, every merged id live and rescored); and
   ``saat_search_vmap`` with the kernel scatter;
9. the single-query wrappers (B = 1) of the scatter, fused top-k, block
   top-k and scoring kernels, each called once on a query of the batch.

Each path runs with the launch counters set to 0 just before and read just
after, and fails if one of its kernels was not launched. It prints each
phase's seconds; last the card's name and power limit, one
``{"kernels": [...]}`` JSON line, and the ``{"ok": true, ...}`` line.

Any mismatch raises, so the run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import namedtuple
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import (  # noqa: E402
    DaatResult,
    block_upper_bounds,
    build_impact_index,
    csr_blockmax_offsets,
    daat_plan,
    daat_search_batched,
    exhaustive_search,
    max_blocks_per_term,
    max_segments_per_term,
    pad_queries,
    query_vector,
    query_vectors,
    saat_plan,
    saat_search,
    score_all_docs,
    score_blocks,
)
from repro_torch.core.daat import _dense_blockmax_rows, _mask_dead_blocks  # noqa: E402
from repro_torch.core.index_handle import IndexHandle  # noqa: E402
from repro_torch.core.saat import _gather_postings_batched, saat_search_vmap  # noqa: E402
from repro_torch.core.topk import topk  # noqa: E402
from repro_torch.data.synthetic import CorpusConfig, generate_corpus  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.block_prune import ops as dense_prune_ops  # noqa: E402
from repro_torch.kernels.block_prune import ref as dense_prune_ref  # noqa: E402
from repro_torch.kernels.block_prune_csr import ops as prune_ops  # noqa: E402
from repro_torch.kernels.block_prune_csr import ref as prune_ref  # noqa: E402
from repro_torch.kernels.block_topk import ops as btopk_ops  # noqa: E402
from repro_torch.kernels.block_topk import ref as btopk_ref  # noqa: E402
from repro_torch.kernels.chunk_step import ops as chunk_ops  # noqa: E402
from repro_torch.kernels.chunk_step import ref as chunk_ref  # noqa: E402
from repro_torch.kernels.impact_scatter import ops as scatter_ops  # noqa: E402
from repro_torch.kernels.impact_scatter import ref as scatter_ref  # noqa: E402
from repro_torch.kernels.impact_scatter_topk import ops as fused_ops  # noqa: E402
from repro_torch.kernels.impact_scatter_topk import ref as fused_ref  # noqa: E402
from repro_torch.kernels.sparse_score import ops as score_ops  # noqa: E402
from repro_torch.kernels.sparse_score import ref as score_ref  # noqa: E402
from repro_torch.launch.serve import _mutation_schedule  # noqa: E402
from repro_torch.metrics.ir_metrics import (  # noqa: E402
    cheapest_rho_within_loss,
    mrr_at_k,
    rho_effectiveness_sweep,
)
from repro_torch.metrics.latency import HybridClock, SimulatedClock, summarize_latencies  # noqa: E402
from repro_torch.models.treatments import apply_treatment  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionQueue,
    AnytimeServer,
    CompactionPolicy,
    Compactor,
    ServingConfig,
    effective_lq,
    pad_to_width,
    replay_arrivals,
    replay_with_churn,
    run_query_stream,
    sentinel_rows,
)

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
# The scatter kernels at their edges (scatter_edge_inputs): 8 blocks of 512,
# the last ragged; k_blk on both sides of fused_ops.SELECT_MAX_K and at block_d.
SCATTER_EDGE = dict(batch=3, n_docs=4000, block_d=512, tile_p=512, empty=2, long=5, dead=6)
SCATTER_EDGE_KS = (1, 10, 16, 32, 33, 512)
PRUNE_CASES = (
    ("b1", dict(batch=1, lq=8, nb=100, m=16, n_bm=800)),
    ("b4_wide", dict(batch=4, lq=32, nb=2048, m=64, n_bm=12000)),
    ("b3_tiny", dict(batch=3, lq=5, nb=17, m=3, n_bm=40)),
    ("b2_single_slot", dict(batch=2, lq=1, nb=64, m=8, n_bm=100)),
)
BTOPK_CASES = (
    ("ragged", dict(n=1000, k=10, tile=256)),
    ("aligned", dict(n=8192, k=100, tile=1024)),
    ("k_is_n", dict(n=100, k=100, tile=128)),
    ("wide_tile", dict(n=5000, k=7, tile=512)),
    ("b1", dict(batch=1, n=1000, k=10, tile=256)),
    ("b3_ragged", dict(batch=3, n=517, k=7, tile=128)),
    ("b8_k_is_n", dict(batch=8, n=100, k=100, tile=128)),
)
# block_topk at its edges: the engine's [64, 2159] bounds fully tied, with
# every k it uses and k = 1; a row of all -inf; widths that are not a
# multiple of 32; k past n; B = 1.
BTOPK_EDGE_CASES = (
    ("tied_b64_n2159_k1", dict(batch=64, n=2159, k=1, tile=8192)),
    ("tied_b64_n2159_k8", dict(batch=64, n=2159, k=8, tile=8192)),
    ("tied_b64_n2159_k16", dict(batch=64, n=2159, k=16, tile=8192)),
    ("neginf_rows_b4_n2159_k16", dict(batch=4, n=2159, k=16, tile=8192, neg_inf_rows=2)),
    ("ragged_b5_n45_k7", dict(batch=5, n=45, k=7, tile=8192)),
    ("ragged_b3_n1001_k1000", dict(batch=3, n=1001, k=1000, tile=8192)),
    ("k_past_n_b2_n45_k60", dict(batch=2, n=45, k=60, tile=8192)),
    ("b1_n2159_k16", dict(n=2159, k=16, tile=8192)),
)
SCORE_CASES = (
    ("small", dict(n=100, tmax=16, lq=8)),
    ("aligned", dict(n=512, tmax=64, lq=32)),
    ("ragged", dict(n=130, tmax=7, lq=3)),
    ("b1", dict(batch=1, n=100, tmax=16, lq=8)),
    ("b3_ragged", dict(batch=3, n=130, tmax=7, lq=3)),
    ("b4_aligned", dict(batch=4, n=512, tmax=64, lq=32)),
)
# sparse_score's store-addressed entry at its edges (store_inputs): the split
# trip's widths (16 blocks of 128 a query, Tmax 650, Lq 35) on a small store.
STORE_EDGE = dict(n_blocks=24, block_size=128, tmax=650, vocab=3000, batch=64, lq=35, nb=16)
_CHUNK = dict(n_docs=220, block_size=32, lq=6)
_CHUNK24 = dict(n_docs=130, block_size=24, lq=4)
CHUNK_CASES = (
    tuple((f"b{B}_budget{budget}_k{k}", dict(_CHUNK, B=B, budget=budget, k=k))
          for B in (1, 3) for budget in (1, 3, 7) for k in (1, 5))
    + (("ragged_bs24", dict(_CHUNK24, B=2, budget=5, k=3)),)
    + tuple((f"multi_b{B}_trips{trips}_budget{budget}", dict(_CHUNK, B=B, trips=trips,
                                                             budget=budget, k=5))
            for B, trips, budget in ((1, 1, 3), (3, 3, 7), (2, 4, 2)))
    + (("multi_ragged_bs24", dict(_CHUNK24, B=2, trips=2, budget=5, k=3)),
       ("live_b2_budget3", dict(_CHUNK, B=2, budget=3, k=5, live=1)),
       ("multi_live_b2_trips3", dict(_CHUNK, B=2, trips=3, budget=3, k=5, live=1)))
)

# The dense block_prune contract (src/repro/kernels/block_prune/ops.py),
# copied; the kernel tiles the block axis itself (no block_nb).
DENSE_PRUNE_CASES = (
    ("narrow", dict(lq=8, nb=100)),
    ("wide", dict(lq=32, nb=2048)),
    ("tiny_ragged", dict(lq=5, nb=17)),
    ("b1", dict(batch=1, lq=8, nb=100)),
    ("b4_wide", dict(batch=4, lq=32, nb=2048)),
    ("b3_tiny", dict(batch=3, lq=5, nb=17)),
)

# Serving at the defaults of the serving CLI (src/repro_torch/launch/serve.py):
# the rho ladder (capped at exact by the server), Lq buckets covering the
# longest query, queue shapes, a 25 ms request deadline, 2,000 qps.
SERVE_K = 10
SERVE_LADDER = (100_000, 500_000, 1_000_000, 5_000_000)
QUEUE_SHAPES = (8, 32)
QUEUE_DEADLINE_MS = 25.0
QUEUE_QPS = 2000.0
QUEUE_SAFETY_MS = 2.0
QUEUE_REQUESTS = 1024
CHURN_REQUESTS = 512
CHURN_MUTATE_QPS = 800.0

# DAAT at the reference's serving defaults (src/repro/serving/scheduler.py)
DAAT_KW = dict(est_blocks=8, block_budget=16)
DAAT_RUNS = ((10, True), (10, False), (1000, True))  # (k, exact)
DAAT_MODES = (
    ("plain", {}),
    ("split", dict(use_kernels=True)),
    ("fused", dict(use_kernels=True, fused_chunk=True)),
    ("multi", dict(use_kernels=True, fused_chunk=True, trips_per_launch=8)),
)
STAT_FIELDS = ("n_survivors", "blocks_scored", "chunks", "rank_safe")

# Every kernel: its launch counter (module, attribute), its source, the
# Pallas entry it replaces and the main path that launches it. The kernels
# line reports each at the first main-shape row of its phase.
Kernel = namedtuple("Kernel", "module counter source replaces path")
KERNELS = {
    "impact_scatter": Kernel(scatter_ops, "LAUNCHES", "src/repro_torch/csrc/impact_scatter.cu",
                             "src/repro/kernels/impact_scatter/kernel.py:83", "saat"),
    "impact_scatter_topk": Kernel(fused_ops, "LAUNCHES", "src/repro_torch/csrc/impact_scatter_topk.cu",
                                  "src/repro/kernels/impact_scatter_topk/kernel.py:229", "saat"),
    "block_prune_csr": Kernel(prune_ops, "LAUNCHES", "src/repro_torch/csrc/block_prune_csr.cu",
                              "src/repro/kernels/block_prune_csr/kernel.py:84", "daat"),
    "block_topk": Kernel(btopk_ops, "LAUNCHES", "src/repro_torch/csrc/block_topk.cu",
                         "src/repro/kernels/block_topk/kernel.py:41", "daat"),
    # the DAAT engine scores through the store-addressed entry; the
    # gathered-rows entry (the Pallas kernel's own contract) is what the
    # B=1 wrapper launches
    "sparse_score": Kernel(score_ops, "STORE_LAUNCHES", "src/repro_torch/csrc/sparse_score.cu",
                           "src/repro/kernels/sparse_score/kernel.py:42", "daat"),
    "chunk_step": Kernel(chunk_ops, "LAUNCHES", "src/repro_torch/csrc/chunk_step.cu",
                         "src/repro/kernels/chunk_step/kernel.py:295", "daat"),
    "chunk_step_multi": Kernel(chunk_ops, "MULTI_LAUNCHES", "src/repro_torch/csrc/chunk_step.cu",
                               "src/repro/kernels/chunk_step/kernel.py:375", "daat"),
    # the dense prune runs on its oracle path only (no engine calls it);
    # the B=1 entry is a wrapper over the same kernel and counter
    "block_prune": Kernel(dense_prune_ops, "LAUNCHES", "src/repro_torch/csrc/block_prune.cu",
                          "src/repro/kernels/block_prune/kernel.py:42", "dense"),
    "block_prune_b1": Kernel(dense_prune_ops, "LAUNCHES", "src/repro_torch/csrc/block_prune.cu",
                             "src/repro/kernels/block_prune/kernel.py:74", "dense"),
    # the single-query Pallas entries: B=1 wrappers over the batched kernels
    # and their counters, each driven once by single_query_phase
    "impact_scatter_b1": Kernel(scatter_ops, "LAUNCHES", "src/repro_torch/csrc/impact_scatter.cu",
                                "src/repro/kernels/impact_scatter/kernel.py:134", "single"),
    "impact_scatter_topk_b1": Kernel(fused_ops, "LAUNCHES",
                                     "src/repro_torch/csrc/impact_scatter_topk.cu",
                                     "src/repro/kernels/impact_scatter_topk/kernel.py:157", "single"),
    "block_topk_b1": Kernel(btopk_ops, "LAUNCHES", "src/repro_torch/csrc/block_topk.cu",
                            "src/repro/kernels/block_topk/kernel.py:75", "single"),
    "sparse_score_b1": Kernel(score_ops, "LAUNCHES", "src/repro_torch/csrc/sparse_score.cu",
                              "src/repro/kernels/sparse_score/kernel.py:91", "single"),
}
SINGLE_KERNELS = {n: n[:-3] for n, kern in KERNELS.items() if kern.path == "single"}
SAAT_KERNELS = tuple(n for n, kern in KERNELS.items() if kern.path == "saat")
DAAT_KERNELS = tuple(n for n, kern in KERNELS.items() if kern.path == "daat")


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


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls captured in one CUDA
    graph and replayed: the card runs them back to back, with none of the
    host's launch cost between them."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def timings(kernel, plain, library=None, plain_iters: int = 10) -> dict:
    """A row's times: the kernel and its library yardstick with CUDA events
    around back-to-back calls and replayed from a CUDA graph, and the plain
    version with CUDA events."""
    return dict(
        ms=cuda_ms(kernel), graph_ms=graph_ms(kernel),
        plain_ms=cuda_ms(plain, iters=plain_iters, warmup=min(2, plain_iters - 1)),
        library_ms=None if library is None else cuda_ms(library),
        library_graph_ms=None if library is None else graph_ms(library),
    )


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


def reset_launches() -> None:
    for kern in KERNELS.values():
        setattr(kern.module, kern.counter, 0)


def read_launches() -> dict:
    return {name: getattr(kern.module, kern.counter) for name, kern in KERNELS.items()}


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
    check(torch.equal(got.cpu(), want), f"impact_scatter {what}: sums differ in their bits")
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
            **timings(lambda: scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d),
                      lambda: scatter_ref.impact_scatter_batched_ref(docs, c, n_docs_pad),
                      lambda: torch.zeros((B, n_docs_pad + 1), device=docs.device)
                      .scatter_add_(1, docs_long, c)),
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
    check(torch.equal(gs.cpu(), ws), f"impact_scatter_topk {what}: scores differ in their bits")
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
            **timings(lambda: fused_ops.impact_scatter_topk_launch(
                docs, c, n_docs_pad, n_docs, k_blk, block_d, live_pad),
                lambda: fused_ref.impact_scatter_topk_block_ref(
                    docs, c, n_docs_pad, n_docs, k_blk, block_d, live_pad), library),
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


def scatter_edge_inputs(seed, device):
    """Postings for the scatter kernels' edges (``SCATTER_EDGE``): block
    ``empty`` gets no postings, block ``long`` a range over more than three
    shared-memory stages, every doc of block ``dead`` is tombstoned in the
    bitmap, the last block holds pad docs, and contributions of three
    integer values tie most scores."""
    e = SCATTER_EDGE
    rng = np.random.default_rng(seed)
    bd, n_docs, B = e["block_d"], e["n_docs"], e["batch"]
    stage = common.scatter_shape(bd)["stage"]
    docs = rng.integers(0, n_docs, (B, 6000))
    docs = np.where(docs // bd == e["empty"], docs - bd, docs)
    long_run = rng.integers(e["long"] * bd, (e["long"] + 1) * bd, (B, 3 * stage + 100))
    docs = np.concatenate([docs, long_run], axis=1)
    contribs = rng.integers(1, 4, docs.shape).astype(np.float32)
    live = rng.random(n_docs) < 0.9
    live[e["dead"] * bd:(e["dead"] + 1) * bd] = False
    blocks = docs // bd
    check(not (blocks == e["empty"]).any() and bool(((blocks == e["long"]).sum(axis=1) > 3 * stage).all()),
          "scatter edge inputs: a block is not empty or a range does not span three stages")
    return (torch.as_tensor(docs, dtype=torch.int32, device=device),
            torch.as_tensor(contribs, device=device),
            torch.as_tensor(live, dtype=torch.int32, device=device))


def scatter_edge_phases(device, seed) -> None:
    """Both scatter kernels bit for bit against their plain versions at the
    edges, the fused kernel at each k_blk of ``SCATTER_EDGE_KS`` (both sides
    of the select-or-sort rule), with and without the bitmap."""
    e = SCATTER_EDGE
    docs, contribs, live = scatter_edge_inputs(seed, device)
    scatter_phase(docs, contribs, e["n_docs"], e["block_d"], e["tile_p"], single=False,
                  timed=False, what="edge")
    for k in SCATTER_EDGE_KS:
        for lv in (None, live):
            topk_phase(docs, contribs, e["n_docs"], k, e["block_d"], e["tile_p"], lv, single=False,
                       timed=False, what=f"edge k={k}{' live' if lv is not None else ''}")
    routes = {k: "select" if fused_ops.use_select(min(k, e["block_d"])) else "sort"
              for k in SCATTER_EDGE_KS}
    print(f"scatter edge phases: impact_scatter and impact_scatter_topk equal their plain versions "
          f"bit for bit (an empty block, a range over 3 or more stages, a dead block, pad "
          f"docs, tied scores) at k_blk {routes}")


def select_sweep(docs, c, n_docs_pad, n_live, block_d) -> None:
    """The fused kernel's block top-k by the select and by the sort at each
    k_blk, replayed from a CUDA graph; both equal."""
    rule = fused_ops.use_select
    try:
        for k in (1, 10, 16, 32, 64):
            times, outs = {}, {}
            for route in ("select", "sort"):
                fused_ops.use_select = lambda k_blk, route=route: route == "select"
                outs[route] = fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, k,
                                                                   block_d)
                times[route] = graph_ms(lambda: fused_ops.impact_scatter_topk_launch(
                    docs, c, n_docs_pad, n_live, k, block_d), 20)
            check(all(torch.equal(a, b) for a, b in zip(outs["select"], outs["sort"])),
                  f"impact_scatter_topk k={k}: the select and the sort differ")
            print(f"  impact_scatter_topk select sweep k_blk={k}: ms (CUDA graph) {json.dumps(times)}"
                  f"; the rule takes the {'select' if rule(k) else 'sort'}")
    finally:
        fused_ops.use_select = rule


def scatter_shape_sweep(docs, c, n_docs_pad, n_live, block_d) -> None:
    """Both scatter kernels (the fused one at k = 10) at each CTA shape:
    docs a thread and postings staged a doc, replayed from a CUDA graph;
    every shape's output equal to the wrapper's own choice's."""
    chosen = common.scatter_shape
    want = (scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d),
            *fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, 10, block_d))
    times = {}
    try:
        for dpt in (1, 2, 4):
            for per_doc in (1, 2, 4):
                stage = per_doc * block_d
                common.scatter_shape = lambda bd, dpt=dpt, stage=stage: dict(
                    dpt=dpt, threads=bd // dpt, stage=stage, smem=8 * stage + 4 * bd)
                got = (scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d),
                       *fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, 10,
                                                             block_d))
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"scatter kernels at {dpt} docs a thread, stage {stage}: output differs")
                times[f"dpt{dpt} stage{stage}"] = [
                    graph_ms(lambda: scatter_ops.impact_scatter_launch(docs, c, n_docs_pad,
                                                                       block_d), 20),
                    graph_ms(lambda: fused_ops.impact_scatter_topk_launch(
                        docs, c, n_docs_pad, n_live, 10, block_d), 20)]
    finally:
        common.scatter_shape = chosen
    print(f"  scatter shape sweep B={docs.shape[0]} block_d={block_d}: ms (CUDA graph) "
          f"[impact_scatter, impact_scatter_topk k=10] by shape {json.dumps(times)}; the "
          f"wrappers take {json.dumps(chosen(block_d))}")


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
    for k in (1, 16):
        rows["impact_scatter_topk"].append(topk_phase(
            docs, contribs, index.n_docs, k, 512, 512, None, single=False, timed=False,
            what=f"edge B={B} rho=1M k={k}"))
    pad = common.round_up(index.n_docs, 512)
    sd, sc = common.sorted_posting_tiles(docs, contribs, pad, 512)
    select_sweep(sd, sc, pad, index.n_docs, 512)
    scatter_shape_sweep(sd, sc, pad, index.n_docs, 512)
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


def near(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Equal (-inf included) or within RTOL/ATOL."""
    return (a == b) | ((a - b).abs() <= ATOL + RTOL * b.abs())


def tie_swaps(got_s, got_i, want_s, want_i, what) -> int:
    """Scores agree rank by rank within tolerance. Where the ids differ at a
    rank with a finite score, each of the two docs must stand in the other
    list with a score within tolerance of its own or, if the other list left
    it out, within tolerance of that list's last score: a near-tie that
    summation order may break either way. Returns how many ranks differ."""
    max_err(got_s, want_s, what)
    got_s, want_s = got_s.float().cpu(), want_s.float().cpu()
    got_i, want_i = got_i.cpu().long(), want_i.cpu().long()
    differ = (got_i != want_i) & torch.isfinite(got_s)
    for q in torch.nonzero(differ.any(dim=-1)).flatten().tolist():
        ranks = torch.nonzero(differ[q]).flatten()
        for a_s, a_i, b_s, b_i in ((got_s[q], got_i[q], want_s[q], want_i[q]),
                                   (want_s[q], want_i[q], got_s[q], got_i[q])):
            hit = (a_i[ranks, None] == b_i[None, :]) & torch.isfinite(b_s)[None, :]
            other = torch.where(hit.any(dim=1), b_s[hit.float().argmax(dim=1)], b_s[-1])
            bad = ~near(a_s[ranks], other)
            check(not bool(bad.any()),
                  f"{what}: query {q}: docs {a_i[ranks][bad][:4].tolist()} scored "
                  f"{a_s[ranks][bad][:4].tolist()} here and {other[bad][:4].tolist()} in the "
                  f"other list (or its last score): not a near-tie")
    return int((got_i != want_i).sum())


def rescore(index, qt, qw, scores, ids, what, live=None) -> None:
    """The returned ids carry the returned scores: every finite score lies
    within RTOL/ATOL of its doc's score by the plain scorer, and under a
    tombstone bitmap every such doc is live."""
    fin = torch.isfinite(scores)
    docs = torch.where(fin, ids, 0).long()
    qvec = query_vectors(index, qt, qw)
    rows = torch.arange(qvec.shape[0], device=qvec.device)[:, None, None]
    want = torch.sum(qvec[rows, index.doc_terms[docs].long()] * index.doc_weights[docs], dim=-1)
    bad = fin & ~near(scores.float(), want)
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} returned ids do not carry their "
                               f"scores (the plain scorer differs beyond tolerance)")
    if live is not None:
        check(bool((live[docs] != 0)[fin].all()), f"{what}: a tombstoned doc was returned")


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


# ---------------------------------------------------------------------------
# DAAT kernel phases: block_prune_csr (B3), block_topk (B6), sparse_score
# (B7), chunk_step (B4) and chunk_step_multi (B5) against their plain
# versions, run on a host copy of the inputs.
# ---------------------------------------------------------------------------


def host(t):
    return None if t is None else t.cpu()


def prune_inputs(dims: dict, seed: int, device):
    """CSR block-max lists of random terms and per-(query, slot) windows into
    them, a fifth of them empty pad slots; one row with theta = -inf."""
    rng = np.random.default_rng(seed)
    nb, m, n_bm = dims["nb"], dims["m"], dims["n_bm"]
    starts, counts, total = [], [], 0
    bm_block = np.zeros(n_bm, np.int32)
    while True:
        c = int(min(rng.integers(1, 2 * m + 1), nb))
        if total + c > n_bm:
            break
        bm_block[total:total + c] = np.sort(rng.choice(nb, c, replace=False))
        starts.append(total)
        counts.append(c)
        total += c
    bm_weight = np.zeros(n_bm, np.float32)
    bm_weight[:total] = rng.gamma(1.0, 1.0, total)
    terms = rng.integers(0, len(starts), (dims["batch"], dims["lq"]))
    base = np.asarray(starts, np.int32)[terms]
    cnt = np.minimum(np.asarray(counts, np.int32)[terms], m)
    qw = rng.gamma(1.0, 1.0, terms.shape).astype(np.float32)
    empty = rng.random(terms.shape) < 0.2
    base[empty], cnt[empty], qw[empty] = total, 0, 0.0
    theta = rng.uniform(0.0, 2.0, dims["batch"]).astype(np.float32)
    theta[0] = -np.inf
    return tuple(torch.as_tensor(a, device=device)
                 for a in (bm_block, bm_weight, base, cnt, qw, theta))


def prune_phase(args, n_blocks, timed, what) -> dict:
    """block_prune_csr: ub equal bit for bit and the mask equal."""
    bm_block, bm_weight, base, cnt, qw, theta = args
    m = max(1, int(cnt.max()))
    gu, gm = prune_ops.block_prune_csr_launch(*args, n_blocks)
    wu, wm = prune_ref.block_prune_csr_batched_ref(*(a.cpu() for a in args), n_blocks=n_blocks,
                                                   max_bm_per_term=m)
    sync()
    check(torch.equal(gu.cpu(), wu), f"block_prune_csr {what}: ub differs from the plain version")
    check(torch.equal(gm.cpu(), wm), f"block_prune_csr {what}: mask differs")
    row = {"what": what, "max_abs_err": 0.0}
    if timed:
        B, lq = base.shape
        offs = torch.arange(m, device=base.device)
        idx = base[..., None] + offs
        valid = offs < cnt[..., None]
        idx = torch.where(valid, idx, 0).long()
        blocks = torch.where(valid, bm_block[idx], 0).long().reshape(B, -1)
        w = (torch.where(valid, bm_weight[idx], 0.0) * qw[..., None]).reshape(B, -1)
        n_entries = int(cnt.sum())
        row.update(
            **timings(lambda: prune_ops.block_prune_csr_launch(*args, n_blocks),
                      lambda: prune_ref.block_prune_csr_batched_ref(
                          *args, n_blocks=n_blocks, max_bm_per_term=m),
                      lambda: torch.zeros((B, n_blocks), device=w.device)
                      .scatter_add_(1, blocks, w)),
            # each window entry read once (block id and maximum), the slot
            # descriptors read once, ub (f32) and the mask (bool) written once
            bound_ms=1e3 * (8 * n_entries + 12 * B * lq + 5 * B * n_blocks) / HBM_BYTES_PER_S,
            entries=n_entries, shape=[B, lq, n_blocks],
        )
    return row


def tied_scores(shape, seed, device, neg_inf_rows=0):
    """Few distinct values, so most scores tie; a tenth of them -inf, and
    the first ``neg_inf_rows`` rows all -inf."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, shape).astype(np.float32)
    s[rng.random(shape) < 0.1] = -np.inf
    s[:neg_inf_rows] = -np.inf
    return torch.as_tensor(s, device=device)


def btopk_phase(scores, k, tile, single, timed, what) -> dict:
    """block_topk: stage 1 against its plain version, and the wrapper
    (stage 1 and the merge) against the plain wrapper: ids and scores equal."""
    b, n = scores.shape
    tile = min(tile, max(128, n))
    s = common.pad_axis(scores, 1, tile, fill=float("-inf")).contiguous()
    k_tile = min(max(min(k, n), 1), tile)
    gs, gi = btopk_ops.block_topk_launch(s, k_tile, tile)
    ws, wi = btopk_ref.block_topk_stage1_ref(s.cpu(), k_tile, tile)
    sync()
    ids_equal(gi, wi, f"block_topk {what}")
    check(torch.equal(gs.cpu(), ws), f"block_topk {what}: scores differ")
    if single:
        gs, gi = (t[None] for t in btopk_ops.block_topk(scores[0], k, tile=tile))
    else:
        gs, gi = btopk_ops.block_topk_batched(scores, k, tile=tile)
    ws, wi = btopk_ops.block_topk_batched(scores.cpu(), k, tile=tile)
    ids_equal(gi, wi, f"block_topk wrapper {what}")
    check(torch.equal(gs.cpu(), ws), f"block_topk wrapper {what}: scores differ")
    row = {"what": what, "max_abs_err": 0.0}
    if timed:
        n_tiles = s.shape[1] // tile
        row.update(
            **timings(lambda: btopk_ops.block_topk_launch(s, k_tile, tile),
                      lambda: btopk_ref.block_topk_stage1_ref(s, k_tile, tile),
                      lambda: torch.topk(scores, min(k, n), dim=-1)),
            bound_ms=1e3 * (4 * b * n + 8 * b * n_tiles * k_tile) / HBM_BYTES_PER_S,
            shape=[b, n, tile, k_tile],
        )
    return row


def score_inputs(dims: dict, seed: int, device):
    """A 50-term vocabulary, so doc terms match often; every query repeats
    its first term in slot 1 and carries a zero-weight slot."""
    rng = np.random.default_rng(seed)
    lead = (dims.get("batch", 1),)
    dt = rng.integers(0, 50, lead + (dims["n"], dims["tmax"])).astype(np.int32)
    dw = rng.gamma(1.0, 1.0, dt.shape).astype(np.float32)
    qt = rng.integers(0, 50, lead + (dims["lq"],)).astype(np.int32)
    qw = rng.gamma(1.0, 1.0, qt.shape).astype(np.float32)
    if dims["lq"] > 1:
        qt[..., 1] = qt[..., 0]
    if dims["lq"] > 2:
        qw[..., 2] = 0.0
    return tuple(torch.as_tensor(a, device=device) for a in (dt, dw, qt, qw))


def matched_slots(terms, qt, qw) -> int:
    """Term slots whose term is one of their query's nonzero-weight terms:
    the only slots whose weight a scorer must read. ``terms`` holds one
    ``[..., Tmax]`` tensor of doc rows per query."""
    return sum(int(torch.isin(t, q[w > 0]).sum()) for t, q, w in zip(terms, qt, qw))


def needed_slots(n_terms: torch.Tensor, tmax: int) -> int:
    """Term slots a scorer needs of rows holding ``n_terms`` real terms
    each: up to each row's last real term, rounded up to the 32-slot chunk
    a warp reads, and at most the row."""
    return int(torch.clamp((n_terms.long() + 31) // 32 * 32, max=tmax).sum())


def score_phase(args, single, timed, what, n_terms=None) -> dict:
    """sparse_score: the kernel and the wrapper against the plain version,
    scores within RTOL/ATOL (the kernel sums a doc's terms in another order).
    ``n_terms`` (timed rows): each row's count of real terms, for the bound."""
    got = score_ops.sparse_score_launch(*args)
    want = score_ref.sparse_score_batched_ref(*(a.cpu() for a in args))
    sync()
    err = max_err(got, want, f"sparse_score {what}")
    if single:
        wrapped = score_ops.sparse_score(*(a[0] for a in args))[None]
    else:
        wrapped = score_ops.sparse_score_batched(*args)
    err = max(err, max_err(wrapped, want, f"sparse_score wrapper {what}"))
    row = {"what": what, "max_abs_err": err}
    if timed:
        B, n, tmax = args[0].shape
        lq = args[2].shape[1]
        matched = matched_slots(args[0], args[2], args[3])
        slots = needed_slots(n_terms, tmax)
        rest = 4 * matched + 8 * B * lq + 4 * B * n
        row.update(
            **timings(lambda: score_ops.sparse_score_launch(*args),
                      lambda: score_ref.sparse_score_batched_ref(*args), plain_iters=3),
            # every term id read once up to its row's last real term, a
            # weight only where the term matches; beside it the count of
            # whole rows, which this kernel reads (it takes any rows)
            bound_ms=1e3 * (4 * slots + rest) / HBM_BYTES_PER_S,
            bound_padded_ms=1e3 * (4 * B * n * tmax + rest) / HBM_BYTES_PER_S,
            term_slots=slots, matched_slots=matched, shape=[B, n, tmax, lq],
        )
    return row


def store_inputs(seed, device):
    """A doc store as ``build_impact_index`` lays it out (``STORE_EDGE``):
    each row its distinct ascending terms, then the pad term V to its end;
    doc 0 fills all Tmax slots, doc 1 none, doc 2 exactly 7 chunks of 32.
    Integer weights, so every sum is exact in any order. Every query repeats
    its first term in slot 1 and carries a zero-weight slot and a pad slot
    (term V, weight 0). Each query selects 16 distinct blocks, always block
    0 and the last block, whose last 45 docs are pad docs (past n_live)."""
    e = STORE_EDGE
    rng = np.random.default_rng(seed)
    n_blocks, bs, tmax, vocab = e["n_blocks"], e["block_size"], e["tmax"], e["vocab"]
    B, lq, nb = e["batch"], e["lq"], e["nb"]
    dt = np.full((n_blocks * bs, tmax), vocab, np.int32)
    dw = np.zeros((n_blocks * bs, tmax), np.float32)
    lens = rng.integers(0, 400, n_blocks * bs)
    lens[:3] = (tmax, 0, 7 * 32)
    for d, n in enumerate(lens):
        dt[d, :n] = np.sort(rng.choice(vocab, n, replace=False))
        dw[d, :n] = rng.integers(1, 8, n)
    qt = rng.integers(0, vocab, (B, lq)).astype(np.int32)
    qw = rng.integers(1, 5, (B, lq)).astype(np.float32)
    qt[:, 1] = qt[:, 0]
    qw[:, 2] = 0.0
    qt[:, -1], qw[:, -1] = vocab, 0.0
    ids = np.stack([np.concatenate([[0, n_blocks - 1],
                                    1 + rng.choice(n_blocks - 2, nb - 2, replace=False)])
                    for _ in range(B)])
    ids = rng.permuted(ids, axis=1).astype(np.int32)
    return dict(
        store=(torch.as_tensor(dt, device=device), torch.as_tensor(dw, device=device)),
        block_ids=torch.as_tensor(ids, device=device), qt=torch.as_tensor(qt, device=device),
        qw=torch.as_tensor(qw, device=device), block_size=bs, n_live=n_blocks * bs - 45,
        live=torch.as_tensor(rng.random(n_blocks * bs) < 0.8, dtype=torch.int32, device=device),
        block_live=torch.as_tensor(rng.random((B, nb)) < 0.7, device=device),
    )


def store_phase(store, block_ids, qt, qw, *, block_size, n_live, live=None, block_live=None,
                exact, timed, what, n_terms=None) -> dict:
    """sparse_score's store-addressed entry against its plain version
    (gather, the gathered plain version, the masks) on the same inputs: bit
    for bit when ``exact`` (integer weights: every sum is exact in any
    order), else within RTOL/ATOL; every doc it scores equal bit for bit to
    the gathered-rows entry on the gathered rows (the same scorer, stopping
    at the padding), every other doc -inf; the wrapper equal to the launch.
    ``n_terms`` (timed rows): each store row's count of real terms."""
    dt, dw = store
    kw = dict(block_size=block_size, n_live=n_live, live=live, block_live=block_live)
    got = score_ops.sparse_score_blocks_launch(dt, dw, block_ids, qt, qw, **kw)
    want = score_ref.sparse_score_blocks_ref(dt, dw, block_ids, qt, qw, **kw)
    B, nb = block_ids.shape
    flat = (block_ids.long()[..., None] * block_size
            + torch.arange(block_size, device=dt.device)).reshape(B, -1)
    keep = flat < n_live
    if live is not None:
        keep &= live[flat] != 0
    if block_live is not None:
        keep &= block_live.repeat_interleave(block_size, dim=1)
    gathered = score_ops.sparse_score_launch(dt[flat], dw[flat], qt, qw)
    wrapped = score_ops.sparse_score_blocks_batched(dt, dw, block_ids, qt, qw, **kw)
    sync()
    err = max_err(got, want, f"sparse_score store {what}")
    if exact:
        check(torch.equal(got, want), f"sparse_score store {what}: scores differ in their bits")
    check(torch.equal(got[keep], gathered[keep]) and bool(torch.isneginf(got[~keep]).all()),
          f"sparse_score store {what}: differs from the gathered-rows entry")
    check(torch.equal(wrapped, got), f"sparse_score store {what}: the wrapper differs")
    row = {"what": f"store {what}", "max_abs_err": err}
    if timed:
        tmax, lq = dt.shape[1], qt.shape[1]
        docs = [f[k] for f, k in zip(flat, keep)]
        slots = sum(needed_slots(n_terms[d], tmax) for d in docs)
        matched = matched_slots((dt[d] for d in docs), qt, qw)
        n_kept = int(keep.sum())
        checked = (flat < n_live) if block_live is None else (
            (flat < n_live) & block_live.repeat_interleave(block_size, dim=1))
        live_bytes = 4 * int(checked.sum()) if live is not None else 0
        gate_bytes = B * nb if block_live is not None else 0
        rest = 4 * matched + 4 * B * nb * block_size + live_bytes + gate_bytes + 4 * B * nb + 8 * B * lq
        row.update(
            **timings(lambda: score_ops.sparse_score_blocks_launch(dt, dw, block_ids, qt, qw, **kw),
                      lambda: score_ref.sparse_score_blocks_ref(dt, dw, block_ids, qt, qw, **kw),
                      plain_iters=3),
            # each scored doc's term ids up to its last real term (rounded
            # up to the 32-slot chunk), a weight only where the term matches,
            # each score written; beside it the count of whole rows
            bound_ms=1e3 * (4 * slots + rest) / HBM_BYTES_PER_S,
            bound_padded_ms=1e3 * (4 * n_kept * tmax + rest) / HBM_BYTES_PER_S,
            docs_scored=n_kept, term_slots=slots, matched_slots=matched,
            shape=[B, nb * block_size, tmax, lq],
        )
    return row


def span_sweep(store, block_ids, qt, qw, kw) -> None:
    """The store-addressed entry at each span of docs a CTA, replayed from a
    CUDA graph; every span's scores equal the wrapper's own choice's."""
    chosen = score_ops.docs_per_cta
    want = score_ops.sparse_score_blocks_launch(*store, block_ids, qt, qw, **kw)
    B, nb = block_ids.shape
    n = nb * kw["block_size"]
    pick = chosen(B, n, torch.cuda.get_device_properties(qt.device).multi_processor_count)
    times = {}
    try:
        for span in (8, 16, 32, 64, 128, 256, 512):
            score_ops.docs_per_cta = lambda batch, n_docs, n_sms, span=span: span
            got = score_ops.sparse_score_blocks_launch(*store, block_ids, qt, qw, **kw)
            check(torch.equal(got, want), f"sparse_score store at {span} docs a CTA differs")
            times[span] = graph_ms(
                lambda: score_ops.sparse_score_blocks_launch(*store, block_ids, qt, qw, **kw), 20)
    finally:
        score_ops.docs_per_cta = chosen
    print(f"  sparse_score store span sweep B={B} N={n}: ms (CUDA graph) by docs a CTA "
          f"{json.dumps(times)}; the wrapper takes {pick}")


def split_gather_check(index, qt, qw) -> None:
    """One split-mode batch (k = 10, exact): it launches the store-addressed
    scorer and not the gathered-rows one, and its peak device memory above
    what was allocated before stays under one [B, N, Tmax] copy of the term
    ids, the gather it no longer makes."""
    kw = dict(k=10, exact=True, max_bm_per_term=max_blocks_per_term(index), use_kernels=True,
              **DAAT_KW)
    daat_search_batched(index, qt, qw, **kw)
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = (score_ops.LAUNCHES, score_ops.STORE_LAUNCHES)
    daat_search_batched(index, qt, qw, **kw)
    sync()
    extra = torch.cuda.max_memory_allocated() - base
    copy = 4 * qt.shape[0] * DAAT_KW["block_budget"] * index.block_size * index.doc_terms.shape[1]
    check(score_ops.LAUNCHES == before[0] and score_ops.STORE_LAUNCHES > before[1],
          "split mode did not score through the store-addressed entry alone")
    check(extra < copy, f"split mode allocated {extra} B above its inputs, not under one "
                        f"[B, N, Tmax] copy ({copy} B)")
    print(f"  split DAAT batch: {score_ops.STORE_LAUNCHES - before[1]} store-addressed "
          f"sparse_score launches, 0 gathered; peak {extra / 1e6:.1f} MB above its inputs "
          f"(one [B, N, Tmax] copy of the term ids: {copy / 1e6:.1f} MB)")


def store_main_phases(index, qt, qw_raw, state, live) -> list:
    """The store-addressed entry at the split trip's shape (the engine's
    first trip after phase 1: 16 blocks a query, gated by ub > theta) and at
    phase 1's (8 blocks, no gate), timed; then, bit for bit, the trip with
    the index's weights made integers at B = 64, 63 and 1 and under the
    tombstone bitmap, and a synthetic store at its edges (``store_inputs``)."""
    ub, processed, _, _, theta = state
    budget, est, bs = DAAT_KW["block_budget"], DAAT_KW["est_blocks"], index.block_size
    store = (index.doc_terms, index.doc_weights)
    ub_c, b_c = topk(torch.where(processed, float("-inf"), ub), budget)
    b_c = b_c.int().contiguous()
    gate = (ub_c > theta[:, None]).contiguous()
    b_1 = topk(ub, est)[1].int().contiguous()
    B = qt.shape[0]
    main = dict(block_size=bs, n_live=index.n_docs, n_terms=index.doc_n_terms)
    rows = [
        store_phase(store, b_c, qt, qw_raw, block_live=gate, exact=False, timed=True,
                    what=f"B={B} N={budget * bs} trip", **main),
        store_phase(store, b_1, qt, qw_raw, exact=False, timed=True,
                    what=f"B={B} N={est * bs} phase 1", **main),
        store_phase(store, b_c, qt, qw_raw, live=live, block_live=gate, exact=False, timed=False,
                    what=f"B={B} N={budget * bs} trip live", **main),
    ]
    span_sweep(store, b_c, qt, qw_raw, dict(block_size=bs, n_live=index.n_docs, block_live=gate))
    int_store = (index.doc_terms, torch.clamp(torch.round(index.doc_weights * 8), 0, 255))
    int_qw = torch.clamp(torch.round(qw_raw * 8), 0, 63)
    for b in (B, B - 1, 1):
        rows.append(store_phase(int_store, b_c[:b], qt[:b], int_qw[:b], block_size=bs,
                                n_live=index.n_docs, block_live=gate[:b], exact=True, timed=False,
                                what=f"edge B={b} N={budget * bs} trip integer weights"))
    rows.append(store_phase(int_store, b_c, qt, int_qw, block_size=bs, n_live=index.n_docs,
                            live=live, block_live=gate, exact=True, timed=False,
                            what=f"edge B={B} N={budget * bs} trip integer weights live"))
    del int_store
    e = store_inputs(0, qt.device)
    cases = {"B=64": (64, False, False), "B=63": (63, False, False), "B=1": (1, False, False),
             "live": (64, True, False), "gate": (64, False, True), "live gate": (64, True, True)}
    for name, (b, lv, gt) in cases.items():
        rows.append(store_phase(e["store"], e["block_ids"][:b], e["qt"][:b], e["qw"][:b],
                                block_size=e["block_size"], n_live=e["n_live"],
                                live=e["live"] if lv else None,
                                block_live=e["block_live"][:b] if gt else None, exact=True,
                                timed=False, what=f"edge synthetic {name}"))
    split_gather_check(index, qt, qw_raw)
    return rows


def phase1_state(index, qt, qw, k, est_blocks, live=None):
    """The DAAT engine's phase-1 state (plain pieces): ub, processed, the
    pool and theta after the ``est_blocks`` highest-bound blocks are scored."""
    ub, qvec = daat_plan(index, qt, qw, max_blocks_per_term(index))
    if live is not None:
        ub = _mask_dead_blocks(index, ub, live)
    B = qt.shape[0]
    _, b1 = topk(ub, est_blocks)
    s1, d1 = score_blocks(index, qvec, b1, live)
    pool_s, pos = topk(s1.reshape(B, -1), k)
    pool_i = torch.gather(d1.reshape(B, -1), -1, pos).to(torch.int32)
    processed = torch.zeros((B, index.n_blocks), dtype=torch.bool, device=ub.device)
    processed.scatter_(1, b1.long(), True)
    return ub, processed, pool_s, pool_i, pool_s[:, k - 1]


def near_tie_rows(ub, thetas) -> torch.Tensor:
    """Rows where some block's bound lies within RTOL of one of the row's
    thetas: there a last-bit difference may flip the live gate."""
    ub = ub.float().cpu()
    out = torch.zeros(ub.shape[0], dtype=torch.bool)
    for th in thetas:
        th = th.float().cpu()[:, None]
        out |= (torch.isfinite(ub) & ((ub - th).abs() <= RTOL * th.abs())).any(dim=-1)
    return out


def close_rows(got_s, want_s) -> torch.Tensor:
    """Rows whose scores agree rank by rank within RTOL/ATOL, -inf where and
    only where the other has -inf."""
    got_s, want_s = got_s.float().cpu(), want_s.float().cpu()
    fin = torch.isfinite(want_s)
    same_pattern = (torch.isfinite(got_s) == fin) & (torch.isneginf(got_s) == torch.isneginf(want_s))
    diff = torch.where(fin, (got_s - want_s).abs(), 0.0)
    ok = same_pattern & (diff <= ATOL + RTOL * want_s.abs().nan_to_num(0.0, 0.0, 0.0))
    return ok.reshape(ok.shape[0], -1).all(dim=-1)


def chunk_phase(index, qt, qw_raw, state, budget, live, trips, timed, what,
                vary_trips=False) -> dict:
    """chunk_step (trips None) or chunk_step_multi against its plain version.
    ``vary_trips``: row b of a multi-trip launch gets 1 + b % trips trips,
    so rows leave the launch at different trips.

    Rows whose processed row, trip count, theta or scores differ must have a
    near-tie (a block bound within RTOL of a theta of the plain trip
    sequence); the others must agree: processed and trips_done equal, scores
    and theta within RTOL/ATOL, ids equal but at near-tied ranks (counted)."""
    ub, processed, pool_s, pool_i, theta = state
    kw = dict(block_budget=budget, block_size=index.block_size, n_live=index.n_docs)
    args = (index.doc_terms, index.doc_weights, qt, qw_raw, ub, processed, pool_s, pool_i, theta)
    hargs = tuple(a.cpu() for a in args)
    B = ub.shape[0]
    if trips is None:
        got = chunk_ops.chunk_step_batched(*args, live=live, **kw)
        want = chunk_ref.chunk_step_batched_ref(*hargs, live=host(live), **kw)
        got, want = got + (torch.ones(B, dtype=torch.int32),), want + (torch.ones(B, dtype=torch.int32),)
        trips_left = None
    else:
        # as the engine: every row that can still move gets the whole budget
        active = torch.where(processed, float("-inf"), ub).amax(dim=-1) > theta
        budgets = 1 + torch.arange(B, device=ub.device) % trips if vary_trips else trips
        trips_left = torch.where(active, budgets, 0).to(torch.int32)
        got = chunk_ops.chunk_step_multi_batched(*args, trips_left, trips_per_launch=trips,
                                                 live=live, **kw)
        want = chunk_ref.chunk_step_multi_batched_ref(*hargs, trips_left.cpu(),
                                                      trips_per_launch=trips, live=host(live), **kw)
    sync()
    got = tuple(t.cpu() for t in got)
    gs, gi, gth, gpr, gtd = got
    ws, wi, wth, wpr, wtd = want
    ok = ((gpr == wpr).all(dim=-1) & (gtd == wtd) & close_rows(gs, ws)
          & close_rows(gth[:, None], wth[:, None]))
    bad = ~ok
    if bool(bad.any()):
        # the plain trip sequence's thetas, one trip at a time
        thetas, st = [theta, wth, gth], hargs[4:]
        for t in range(1 if trips is None else trips):
            ns, ni, nth, npr = chunk_ref.chunk_step_batched_ref(*hargs[:4], *st, live=host(live),
                                                                **kw)
            thetas.append(nth)
            st = (st[0], npr, ns, ni, nth)
        tied = near_tie_rows(hargs[4], thetas)
        check(not bool((bad & ~tied).any()),
              f"{what}: rows {torch.nonzero(bad & ~tied).flatten().tolist()} differ from the "
              f"plain version with no block bound near-tied with theta")
    swaps = tie_swaps(gs[ok], gi[ok], ws[ok], wi[ok], what)
    rescore(index, qt, qw_raw, gs.to(ub.device), gi.to(ub.device), what, live)
    fin = torch.isfinite(ws) & ok[:, None]
    err = float((gs - ws).abs()[fin].max()) if bool(fin.any()) else 0.0
    row = {"what": what, "max_abs_err": err, "near_tied_rows": int(bad.sum()), "id_swaps": swaps}
    if timed:
        # what this data needs: the rows of the live docs of the blocks the
        # trips scored (4 B per term id, a weight only where the term
        # matches; the kernel reads no other block), the live bit of every
        # doc of those blocks, the ub and processed rows, the pool
        new = (wpr & ~hargs[5]).to(ub.device)
        blocks = int(new.sum())
        bs, tmax = index.block_size, index.doc_terms.shape[1]
        nb, k = ub.shape[1], pool_s.shape[1]
        needed = []
        for r in new:
            d = (torch.nonzero(r) * bs + torch.arange(bs, device=ub.device)).flatten()
            keep = d < index.n_docs
            if live is not None:
                keep &= live[d] != 0
            needed.append(d[keep])
        n_rows = sum(len(d) for d in needed)
        slots = sum(needed_slots(index.doc_n_terms[d], tmax) for d in needed)
        matched = matched_slots((index.doc_terms[d] for d in needed), qt, qw_raw)
        if trips is None:
            run_kernel = lambda: chunk_ops.chunk_step_batched(*args, live=live, **kw)  # noqa: E731
            run_plain = lambda: chunk_ref.chunk_step_batched_ref(*args, live=live, **kw)  # noqa: E731
        else:
            run_kernel = lambda: chunk_ops.chunk_step_multi_batched(  # noqa: E731
                *args, trips_left, trips_per_launch=trips, live=live, **kw)
            run_plain = lambda: chunk_ref.chunk_step_multi_batched_ref(  # noqa: E731
                *args, trips_left, trips_per_launch=trips, live=live, **kw)
        live_bytes = 4 * blocks * bs if live is not None else 0
        rest = 4 * matched + live_bytes + 6 * B * nb + 16 * B * k
        row.update(
            **timings(run_kernel, run_plain, plain_iters=2),
            # term ids up to each scored doc's last real term (rounded up to
            # the 32-slot chunk), beside the count of whole padded rows
            bound_ms=1e3 * (4 * slots + rest) / HBM_BYTES_PER_S,
            bound_padded_ms=1e3 * (4 * n_rows * tmax + rest) / HBM_BYTES_PER_S,
            blocks_scored=blocks, doc_rows=n_rows, term_slots=slots, matched_slots=matched,
            trips=int(wtd.sum()), shape=[B, nb, k, budget, tmax],
        )
    return row


def cluster_sweep(index, qt, qw_raw, states, budget) -> None:
    """One chunk_step trip replayed from a CUDA graph at each cluster size,
    for each of ``states`` (k, state), and with theta above every bound (no
    block live, nothing scored: the trip's fixed cost); every size's result
    equal to the wrapper's own choice."""
    kw = dict(block_budget=budget, block_size=index.block_size, n_live=index.n_docs)
    chosen = chunk_ops.cluster_size
    try:
        for k, (ub, processed, pool_s, pool_i, theta) in states:
            for what, th in (("scoring", theta), ("no live block", torch.full_like(theta, np.inf))):
                args = (index.doc_terms, index.doc_weights, qt, qw_raw, ub, processed, pool_s,
                        pool_i, th)
                want = chunk_ops.chunk_step_batched(*args, **kw)
                times = {}
                for size in (1, 2, 4, 8):
                    chunk_ops.cluster_size = lambda batch, n_sms, size=size: size
                    got = chunk_ops.chunk_step_batched(*args, **kw)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"chunk_step at cluster size {size} differs from the wrapper's choice")
                    times[size] = graph_ms(lambda: chunk_ops.chunk_step_batched(*args, **kw), 20)
                    chunk_ops.cluster_size = chosen
                print(f"  chunk_step cluster sweep B={qt.shape[0]} k={k} {what}: ms a trip by "
                      f"cluster size (CUDA graph) {json.dumps(times)}")
    finally:
        chunk_ops.cluster_size = chosen


def tiny_index(n_docs, block_size, seed, device):
    """The reference chunk_step contract's index: 40 terms, 1,500 postings."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, n_docs, 1500)
    t = rng.integers(0, 40, 1500)
    w = rng.gamma(2.0, 1.0, 1500)
    return build_impact_index(d, t, w, n_docs, 40, block_size=block_size, device=device)


def daat_contract_phases(device, seed) -> dict:
    """Every DAAT kernel and B=1 wrapper at the reference's contract shapes."""
    errs = dict.fromkeys(DAAT_KERNELS, 0.0)
    for i, (name, dims) in enumerate(PRUNE_CASES):
        prune_phase(prune_inputs(dims, seed + 200 + i, device), dims["nb"], False,
                    f"contract {name}")
    for i, (name, dims) in enumerate(BTOPK_CASES + BTOPK_EDGE_CASES):
        single = "batch" not in dims
        scores = tied_scores((dims.get("batch", 1), dims["n"]), seed + 300 + i, device,
                             dims.get("neg_inf_rows", 0))
        btopk_phase(scores, dims["k"], dims["tile"], single, False, f"contract {name}")
    for i, (name, dims) in enumerate(SCORE_CASES):
        row = score_phase(score_inputs(dims, seed + 400 + i, device), "batch" not in dims, False,
                          f"contract {name}")
        errs["sparse_score"] = max(errs["sparse_score"], row["max_abs_err"])
    for i, (name, dims) in enumerate(CHUNK_CASES):
        index = tiny_index(dims["n_docs"], dims["block_size"], 0, device)
        rng = np.random.default_rng(seed + 500 + i)
        qt = torch.as_tensor(rng.integers(0, 40, (dims["B"], dims["lq"])), dtype=torch.int32,
                             device=device)
        qw = torch.as_tensor(rng.gamma(1.0, 1.0, (dims["B"], dims["lq"])), dtype=torch.float32,
                             device=device)
        live = None
        if dims.get("live"):
            live = torch.as_tensor(rng.random(index.doc_terms.shape[0]) < 0.7, dtype=torch.int32,
                                   device=device)
        state = phase1_state(index, qt, qw, dims["k"], min(2, index.n_blocks), live)
        name_k = "chunk_step_multi" if "trips" in dims else "chunk_step"
        row = chunk_phase(index, qt, qw, state, dims["budget"], live, dims.get("trips"), False,
                          f"contract {name}")
        errs[name_k] = max(errs[name_k], row["max_abs_err"])
    print(f"DAAT contract phases: {len(PRUNE_CASES)} block_prune_csr, "
          f"{len(BTOPK_CASES) + len(BTOPK_EDGE_CASES)} block_topk (ids and scores equal bit for "
          f"bit), {len(SCORE_CASES)} sparse_score and {len(CHUNK_CASES)} chunk_step shapes "
          f"agree with their plain versions; max abs err {errs}")
    return errs


def daat_main_shape_phases(index, qt, qw, live) -> dict:
    """The DAAT kernels at one 64-query batch's shapes: phase 0's CSR
    windows, selection over the [B, n_blocks] bounds (n = est_blocks and
    block_budget), the phase-1 gather, and phase-2 trips on the phase-1
    state, with and without the tombstone bitmap."""
    mb = max_blocks_per_term(index)
    B = qt.shape[0]
    k, est, budget = 10, DAAT_KW["est_blocks"], DAAT_KW["block_budget"]
    rows = {n: [] for n in DAAT_KERNELS}
    base, cnt = csr_blockmax_offsets(index, qt, qw, mb)
    qw_raw = torch.where(qw > 0, qw.float(), 0.0)
    theta = torch.full((B,), float("-inf"), device=qt.device)
    rows["block_prune_csr"].append(prune_phase(
        (index.bm_block, index.bm_weight, base, cnt, qw.float().contiguous(), theta),
        index.n_blocks, True, f"main B={B}"))
    ub = block_upper_bounds(index, qt, qw, mb)
    for n in (budget, est):
        rows["block_topk"].append(btopk_phase(ub, n, 8192, False, True, f"main B={B} k={n}"))
    rows["block_topk"].append(btopk_phase(ub[:1], budget, 8192, True, True,
                                          f"main B=1 k={budget}"))
    qt32 = qt.int().contiguous()
    rows["sparse_score"] += store_main_phases(index, qt32, qw_raw, phase1_state(index, qt, qw, k, est),
                                              live)
    _, b1 = topk(ub, est)
    docs = (b1.long()[..., None] * index.block_size
            + torch.arange(index.block_size, device=ub.device)).reshape(B, -1)
    gathered = (index.doc_terms[docs], index.doc_weights[docs], qt.int().contiguous(),
                qw_raw.contiguous())
    n_terms = index.doc_n_terms[docs]
    rows["sparse_score"].append(score_phase(gathered, False, True, f"main B={B} N={docs.shape[1]}",
                                            n_terms))
    rows["sparse_score"].append(score_phase(tuple(g[:1] for g in gathered), True, True,
                                            f"main B=1 N={docs.shape[1]}", n_terms[:1]))
    del gathered
    for lv in (None, live):
        state = phase1_state(index, qt, qw, k, est, lv)
        tag = " live" if lv is not None else ""
        rows["chunk_step"].append(chunk_phase(index, qt32, qw_raw, state, budget, lv, None, True,
                                              f"main B={B} k={k}{tag}"))
        if lv is None:
            rows["chunk_step_multi"].append(chunk_phase(index, qt32, qw_raw, state, budget, lv, 8,
                                                        True, f"main B={B} k={k} trips=8"))
    # the edges, untimed: the cluster size at B = 63 and B = 1; k = 1000 (the
    # merge with most candidates above theta); tombstones in a multi-trip
    # launch; rows that leave a launch at different trips
    state = phase1_state(index, qt, qw, k, est)
    for b in (B - 1, 1):
        sub = tuple(t[:b] for t in state)
        rows["chunk_step"].append(chunk_phase(index, qt32[:b], qw_raw[:b], sub, budget, None,
                                              None, False, f"edge B={b} k={k}"))
        rows["chunk_step_multi"].append(chunk_phase(index, qt32[:b], qw_raw[:b], sub, budget,
                                                    None, 4, False, f"edge B={b} k={k} trips=4",
                                                    vary_trips=True))
    rows["chunk_step_multi"].append(chunk_phase(index, qt32, qw_raw, phase1_state(
        index, qt, qw, k, est, live), budget, live, 4, False, f"edge B={B} k={k} live trips=4"))
    state1000 = phase1_state(index, qt, qw, 1000, est)
    rows["chunk_step"].append(chunk_phase(index, qt32, qw_raw, state1000, budget, None, None, False,
                                          f"edge B={B} k=1000"))
    rows["chunk_step_multi"].append(chunk_phase(index, qt32, qw_raw, state1000, budget, None, 8,
                                                False, f"edge B={B} k=1000 trips=8",
                                                vary_trips=True))
    cluster_sweep(index, qt32, qw_raw, ((k, state), (1000, state1000)), budget)
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['what']}: " + json.dumps({k: v for k, v in r.items() if k != "what"}))
    return rows


# ---------------------------------------------------------------------------
# the DAAT main path
# ---------------------------------------------------------------------------


def serve_daat(data, n_batches=None, live=None, runs=DAAT_RUNS, modes=DAAT_MODES):
    """Every batch (or the first ``n_batches``) through ``daat_search_batched``
    in every mode. Returns the results, the batch latencies in ms (host
    clock) and the host syncs of each call (one per loop trip, and one to
    find the loop done)."""
    results, latency, syncs = {}, {}, {}
    for m, (index, qt, qw) in data.items():
        mb = max_blocks_per_term(index)
        for lo in range(0, qt.shape[0], BATCH)[:n_batches]:
            bt, bw = qt[lo:lo + BATCH], qw[lo:lo + BATCH]
            for k, exact in runs:
                for mode, flags in modes:
                    multi0 = chunk_ops.MULTI_LAUNCHES
                    sync()
                    t0 = time.perf_counter()
                    res = daat_search_batched(index, bt, bw, k=k, exact=exact, max_bm_per_term=mb,
                                              live_mask=live, **DAAT_KW, **flags)
                    sync()
                    dt = 1e3 * (time.perf_counter() - t0)
                    key = (m, k, exact, mode)
                    results[key + (lo,)] = res
                    latency.setdefault(key, []).append(dt)
                    if exact:
                        trips = (chunk_ops.MULTI_LAUNCHES - multi0 if mode == "multi"
                                 else int(res.chunks.max()))
                        syncs.setdefault(key, []).append(trips + 1)
    return results, latency, syncs


def near_tie_blocks(ub, theta_a, theta_b):
    """(block, ub, theta) of the blocks whose bound lies within RTOL of
    either theta."""
    out = []
    for th in (theta_a, theta_b):
        th = float(th)
        hit = torch.nonzero(torch.isfinite(ub) & ((ub - th).abs() <= RTOL * abs(th))).flatten()
        out += [(int(b), float(ub[b]), th) for b in hit[:3]]
    return out


def oracle_topk(index, bt, bw, k, live):
    """``exhaustive_search``; under a tombstone bitmap, the same with dead
    docs scored -inf."""
    if live is None:
        return exhaustive_search(index, bt, bw, k=k)
    scores, ids = [], []
    for qt_, qw_ in zip(bt, bw):
        s = score_all_docs(index, query_vector(index, qt_, qw_))
        s, i = topk(torch.where(live != 0, s, float("-inf")), k)
        scores.append(s)
        ids.append(i.to(torch.int32))
    return torch.stack(scores), torch.stack(ids)


def verify_daat(data, results, runs=DAAT_RUNS, live=None, modes=("split", "fused", "multi")):
    """Kernel modes equal each other exactly, and the kernel and plain modes
    return ids that carry their scores; against the plain mode on the
    card, scores within RTOL, ids equal but at near-tied ranks, WorkStats
    equal but for queries with a block bound near-tied with theta; at exact,
    every query rank-safe and the ids those of ``exhaustive_search``."""
    swaps, stat_ties, oracle_swaps = 0, 0, 0
    for m, (index, qt, qw) in data.items():
        mb = max_blocks_per_term(index)
        los = sorted({key[-1] for key in results if key[0] == m})
        oracle = {}
        for k, exact in runs:
            for lo in los:
                bt, bw = qt[lo:lo + BATCH], qw[lo:lo + BATCH]
                what = f"DAAT {m} k={k} exact={exact}{' live' if live is not None else ''} batch@{lo}"
                plain = results[(m, k, exact, "plain", lo)]
                first = results[(m, k, exact, modes[0], lo)]
                for mode in modes[1:]:
                    res = results[(m, k, exact, mode, lo)]
                    for field in DaatResult._fields:
                        check(torch.equal(getattr(res, field), getattr(first, field)),
                              f"{what}: {mode} and {modes[0]} differ in {field}")
                for mode, res in ((modes[0], first), ("plain", plain)):
                    rescore(index, bt, bw, res.scores, res.doc_ids, f"{what} {mode}", live)
                swaps += tie_swaps(first.scores, first.doc_ids, plain.scores, plain.doc_ids,
                                   f"{what} vs plain")
                differ = torch.zeros(bt.shape[0], dtype=torch.bool, device=bt.device)
                for field in STAT_FIELDS:
                    differ |= getattr(first, field) != getattr(plain, field)
                if bool(differ.any()):
                    ub = block_upper_bounds(index, bt, bw, mb)
                    if live is not None:
                        ub = _mask_dead_blocks(index, ub, live)
                    for q in torch.nonzero(differ).flatten().tolist():
                        ties = near_tie_blocks(ub[q].cpu(), first.scores[q, k - 1],
                                               plain.scores[q, k - 1])
                        print(f"  {what} query {lo + q}: WorkStats differ from plain mode "
                              f"({[int(getattr(first, f)[q]) for f in STAT_FIELDS]} vs "
                              f"{[int(getattr(plain, f)[q]) for f in STAT_FIELDS]}); "
                              f"near-tied (block, ub, theta): {ties}")
                        check(bool(ties), f"{what} query {lo + q}: WorkStats differ from plain "
                                          f"mode with no block bound near-tied with theta")
                        stat_ties += 1
                if exact:
                    for res in (first, plain):
                        check(bool(res.rank_safe.all()), f"{what}: a query is not rank-safe")
                    if lo not in oracle:
                        oracle[lo] = oracle_topk(index, bt, bw, max(kk for kk, _ in runs), live)
                    o_s, o_i = oracle[lo]
                    oracle_swaps += tie_swaps(first.scores, first.doc_ids, o_s[:, :k], o_i[:, :k],
                                              f"{what} vs exhaustive")
    print(f"verify DAAT: split, fused and multi modes agree exactly; against the plain mode "
          f"{swaps} ranks differ in id between near-tied scores and {stat_ties} queries differ "
          f"in WorkStats at a near-tie; against exhaustive_search {oracle_swaps} ranks differ "
          f"in id between near-tied scores")


def daat_stats(data, results) -> None:
    """The skipping-collapse evidence, per treatment and configuration."""
    for m, (index, _, _) in data.items():
        for k, exact in DAAT_RUNS:
            rs = [r for key, r in results.items() if key[:4] == (m, k, exact, "fused")]
            chunks = torch.cat([r.chunks for r in rs]).float()
            scored = torch.cat([r.blocks_scored for r in rs]).float() / index.n_blocks
            surv = torch.cat([r.n_survivors for r in rs]).float()
            print(f"DAAT work {m} k={k} exact={exact} over {chunks.numel()} queries: chunks mean "
                  f"{float(chunks.mean()):.2f} max {int(chunks.max())}; blocks_scored/n_blocks "
                  f"mean {float(scored.mean()):.4f} max {float(scored.max()):.4f}; n_survivors "
                  f"mean {float(surv.mean()):.1f} max {int(surv.max())} (n_blocks {index.n_blocks})")


def profile_daat_batch(index, bt, bw, k) -> None:
    """One fused DAAT batch (exact) under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(k=k, exact=True, max_bm_per_term=max_blocks_per_term(index), use_kernels=True,
              fused_chunk=True, **DAAT_KW)
    daat_search_batched(index, bt, bw, **kw)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = daat_search_batched(index, bt, bw, **kw)
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    kernels = sorted((e for e in avgs if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    ops = sorted((e for e in avgs if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"profile DAAT spladev2 k={k} exact fused B={bt.shape[0]} ({int(res.chunks.max())} "
          f"trips): profiled wall {wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}%)")
    for what, events in (("operator", ops), ("kernel", kernels)):
        for e in events[:8]:
            print(f"  {what} {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<4d} {e.key[:80]}")


# ---------------------------------------------------------------------------
# the dense block_prune (B8): its oracle path, phase 0 off densified rows,
# held bit for bit against the CSR kernel (B3) and the plain version
# ---------------------------------------------------------------------------


def dense_prune_inputs(dims: dict, seed: int, device):
    """Block maxima with a fifth of the entries 0 (blocks a slot's term
    misses), one zero-weight slot, thetas at a quantile of the bounds."""
    rng = np.random.default_rng(seed)
    B = dims.get("batch", 1)
    bm = rng.gamma(1.0, 1.0, (B, dims["lq"], dims["nb"])).astype(np.float32)
    bm[rng.random(bm.shape) < 0.2] = 0.0
    qw = rng.gamma(1.0, 1.0, (B, dims["lq"])).astype(np.float32)
    if dims["lq"] > 2:
        qw[:, 2] = 0.0
    theta = np.quantile(np.einsum("bl,bln->bn", qw, bm), 0.7, axis=-1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (bm, qw, theta))


def dense_prune_check(got, want, what) -> None:
    check(torch.equal(got[0].cpu(), want[0].cpu()), f"{what}: ub differs bit for bit")
    check(torch.equal(got[1].cpu(), want[1].cpu()), f"{what}: mask differs")


def dense_prune_phase(index, qt, qw, device, seed) -> dict:
    """B8 at the reference's contract shapes against its plain version, then
    on one serving batch: ``_dense_blockmax_rows`` and B8, with theta the
    batch's DAAT k-th scores; ub equal bit for bit to B3's ub, to
    ``block_upper_bounds`` and to the plain version, masks equal."""
    for i, (name, dims) in enumerate(DENSE_PRUNE_CASES):
        args = dense_prune_inputs(dims, seed + 600 + i, device)
        want = dense_prune_ref.block_prune_batched_ref(*(a.cpu() for a in args))
        dense_prune_check(dense_prune_ops.block_prune_launch(*args), want, f"block_prune {name}")
        if "batch" in dims:
            got = dense_prune_ops.block_prune_batched(*args)
        else:
            got = tuple(t[None] for t in dense_prune_ops.block_prune(args[0][0], args[1][0],
                                                                     args[2][0]))
        dense_prune_check(got, want, f"block_prune wrapper {name}")
    sync()
    print(f"dense prune contract phase: {len(DENSE_PRUNE_CASES)} shapes equal to the plain "
          f"version bit for bit")

    mb = max_blocks_per_term(index)
    B = qt.shape[0]
    theta = daat_search_batched(index, qt, qw, k=SERVE_K, exact=True, max_bm_per_term=mb,
                                use_kernels=True, fused_chunk=True,
                                **DAAT_KW).scores[:, SERVE_K - 1].contiguous()
    qwf = qw.float().contiguous()
    dense = _dense_blockmax_rows(index, qt, qw, mb)
    sync()
    launches = {}
    reset_launches()
    ub, mask = dense_prune_ops.block_prune_batched(dense, qwf, theta)  # the oracle path
    sync()
    launches["block_prune"] = dense_prune_ops.LAUNCHES
    reset_launches()
    ub1, mask1 = dense_prune_ops.block_prune(dense[0], qwf[0], theta[0])
    sync()
    launches["block_prune_b1"] = dense_prune_ops.LAUNCHES
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on its oracle path")
    base, cnt = csr_blockmax_offsets(index, qt, qw, mb)
    csr = prune_ops.block_prune_csr_batched(index.bm_block, index.bm_weight, base, cnt, qwf, theta,
                                            n_blocks=index.n_blocks, max_bm_per_term=mb)
    dense_prune_check((ub, mask), csr, f"block_prune main B={B} vs block_prune_csr")
    check(torch.equal(ub, block_upper_bounds(index, qt, qw, mb)),
          "block_prune main: ub differs from block_upper_bounds")
    plain = dense_prune_ref.block_prune_batched_ref(dense.cpu(), qwf.cpu(), theta.cpu())
    dense_prune_check((ub, mask), plain, f"block_prune main B={B} vs plain")
    dense_prune_check((ub1[None], mask1[None]), (ub[:1], mask[:1]), "block_prune main B=1")
    surv = mask.sum(dim=-1).float()
    print(f"dense prune at the serving batch: ub equal bit for bit to block_prune_csr, "
          f"block_upper_bounds and the plain version; {float(surv.mean()):.1f} of "
          f"{index.n_blocks} blocks above theta on average")

    rows = {}
    for name, (bm, w, th) in (("block_prune", (dense, qwf, theta)),
                              ("block_prune_b1", (dense[:1], qwf[:1], theta[:1]))):
        b, lq, nb = bm.shape
        rows[name] = [{
            "what": f"main B={b}", "max_abs_err": 0.0,
            **timings(lambda: dense_prune_ops.block_prune_launch(bm, w, th),
                      lambda: dense_prune_ref.block_prune_batched_ref(bm, w, th),
                      lambda: torch.bmm(w[:, None], bm)),
            # each block maximum, weight and theta read once; ub (f32) and
            # the mask (bool) written once
            "bound_ms": 1e3 * (4 * b * lq * nb + 4 * b * lq + 4 * b + 5 * b * nb)
            / HBM_BYTES_PER_S,
            "shape": [b, lq, nb],
        }]
        print(f"  {name} {rows[name][0]['what']}: "
              + json.dumps({k: v for k, v in rows[name][0].items() if k != "what"}))
    return rows, launches


# ---------------------------------------------------------------------------
# serving: AnytimeServer directly, through the admission queue, DAAT served,
# and the mutable index under churn
# ---------------------------------------------------------------------------


def host_batches(qt_np, qw_np, bs):
    """``run_query_stream``'s batches: fixed size, the last padded with
    repeats of its last row."""
    for lo in range(0, qt_np.shape[0], bs):
        bt, bw = qt_np[lo:lo + bs], qw_np[lo:lo + bs]
        if bt.shape[0] < bs:
            pad = bs - bt.shape[0]
            bt = np.concatenate([bt, np.repeat(bt[-1:], pad, 0)])
            bw = np.concatenate([bw, np.repeat(bw[-1:], pad, 0)])
        yield lo, bt, bw


def latency_line(stats) -> str:
    return (f"p50 {stats.p50_ms:.3f} ms, p99 {stats.p99_ms:.3f} ms, max {stats.max_ms:.3f} ms, "
            f"mean {stats.mean_ms:.3f} ms over {stats.n}")


def serve_direct(index, qt_np, qw_np, qrels) -> None:
    """SAAT through ``AnytimeServer`` (fused kernel) on the serving ladder,
    with a deadline under the top level's calibrated cost, so the controller
    serves a lower rho; every batch equal to ``saat_search`` at the rho the
    server recorded; then the ``--eval-qrels`` sweep."""
    cfg = ServingConfig(k=SERVE_K, rho_ladder=SERVE_LADDER, batch_size=BATCH, fused_topk=True)
    server = AnytimeServer(index, cfg)
    t0 = time.perf_counter()
    server.warmup(qt_np[:BATCH], qw_np[:BATCH])
    warm_s = time.perf_counter() - t0
    pred = {r: server._cost.predict_us(r) / 1e3 for r in server.rho_ladder}  # ms per query
    top = server.rho_ladder[-1]
    lower = [r for r in server.rho_ladder[:-1] if pred[r] < pred[top]]
    check(bool(lower), f"no ladder level is calibrated below the top level: {pred}")
    deadline = 0.5 * (max(pred[r] for r in lower) + pred[top])
    server.cfg = dataclasses.replace(cfg, deadline_ms=deadline)
    print(f"direct serving: ladder {server.rho_ladder}, warm-up {warm_s:.1f} s, calibrated ms "
          f"per query {json.dumps({str(r): round(v, 5) for r, v in pred.items()})}; deadline "
          f"{deadline:.5f} ms per query")
    server.reset_stats()
    reset_launches()
    scores, ids = run_query_stream(server, qt_np, qw_np)
    launches = read_launches()
    check(launches["impact_scatter_topk"] > 0, "direct serving launched no impact_scatter_topk")
    stats = server.stats()
    served = [int(r) for r in server._rhos]
    check(max(served) < top, f"the controller served the top level under deadline {deadline}")
    for lo, bt, bw in host_batches(qt_np, qw_np, BATCH):
        n = min(BATCH, qt_np.shape[0] - lo)
        res = saat_search(index, bt, bw, k=SERVE_K, rho=served[lo],
                          max_segs_per_term=server.max_segs, fused_topk=True)
        check(np.array_equal(res.doc_ids.cpu().numpy()[:n], ids[lo:lo + n]),
              f"direct serving batch@{lo}: ids differ from saat_search at rho {served[lo]}")
        check(np.array_equal(res.scores.cpu().numpy()[:n], scores[lo:lo + n]),
              f"direct serving batch@{lo}: scores differ from saat_search")
    counts = {str(r): served.count(r) for r in sorted(set(served))}
    rr = mrr_at_k(ids, qrels, 10)
    print(f"direct serving: RR@10 {rr:.4f}; served rho (queries) {counts}; per-query latency "
          f"{latency_line(stats)}; launches {launches}; every batch equals saat_search at its rho")
    t0 = time.perf_counter()
    sweep = rho_effectiveness_sweep(server, qt_np, qw_np, qrels, recall_k=SERVE_K,
                                    batch_size=BATCH)
    best = cheapest_rho_within_loss(sweep, max_loss=0.03)
    for row in sweep:
        print(f"  effectiveness rho={row['rho']}: MRR@10 {row['mrr']:.4f} recall@{SERVE_K} "
              f"{row['recall']:.4f} NDCG@10 {row['ndcg']:.4f} loss_mrr {row['loss_mrr']:.4f}")
    print(f"direct serving: rho_within_3pct_mrr_loss {best} (sweep {time.perf_counter() - t0:.1f} s)")


def flush_batch(flush, requests, n_terms):
    """The batch a queue flush served, rebuilt: the requests trimmed to
    their live width, padded to the lane's bucket over inert sentinel rows."""
    qt, qw = sentinel_rows(flush.batch_shape, flush.bucket, n_terms)
    for i, rid in enumerate(flush.rids):
        t, w = requests[rid]
        eff = effective_lq(t[None], w[None], n_terms)
        qt[i], qw[i] = pad_to_width(t[:eff], w[:eff], flush.bucket, n_terms)
    return qt, qw


def serve_queue(index, qt_np, qw_np, qrels, seed) -> None:
    """SAAT (fused) through the admission queue on a HybridClock: Poisson
    arrivals at the CLI's defaults, Lq buckets, degradation on; every
    request completes once, and each equals ``saat_search`` on its flush's
    batch at the flush's rho."""
    n_terms = index.n_terms
    buckets = (8, 16, max(16, qt_np.shape[1]))
    clock = HybridClock()
    cfg = ServingConfig(k=SERVE_K, rho_ladder=SERVE_LADDER, batch_size=QUEUE_SHAPES[-1],
                        fused_topk=True, lq_buckets=buckets)
    server = AnytimeServer(index, cfg, clock=clock)
    queue = AdmissionQueue(server, batch_shapes=QUEUE_SHAPES, clock=clock,
                           safety_ms=QUEUE_SAFETY_MS, degrade_rho=True)
    t0 = time.perf_counter()
    server.warmup(qt_np[:8], qw_np[:8], batch_sizes=QUEUE_SHAPES)
    warm_s = time.perf_counter() - t0
    server.reset_stats()
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / QUEUE_QPS, size=QUEUE_REQUESTS)
    arrivals = clock.now() + np.cumsum(gaps)  # the schedule starts after the warm-up
    order = rng.integers(0, qt_np.shape[0], size=QUEUE_REQUESTS)
    requests = [(qt_np[i], qw_np[i]) for i in order]
    reset_launches()
    t0 = time.perf_counter()
    comps = replay_arrivals(queue, arrivals.tolist(), [r[0] for r in requests],
                            [r[1] for r in requests], [QUEUE_DEADLINE_MS] * QUEUE_REQUESTS)
    replay_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["impact_scatter_topk"] > 0, "queue serving launched no impact_scatter_topk")
    check(sorted(c.rid for c in comps) == list(range(QUEUE_REQUESTS))
          and queue.n_completed == QUEUE_REQUESTS, "queue: a request was lost or served twice")
    by_rid = {c.rid: c for c in comps}
    exact_ids = np.zeros((QUEUE_REQUESTS, SERVE_K), np.int64)  # what no degradation returns
    for f in queue.flush_log:
        bt, bw = flush_batch(f, requests, n_terms)
        served_ids, top_ids = (
            saat_search(index, bt, bw, k=SERVE_K, rho=rho, max_segs_per_term=server.max_segs,
                        fused_topk=True).doc_ids.cpu().numpy()
            for rho in (f.rho, server.rho_ladder[-1]))
        exact_ids[list(f.rids)] = top_ids[:len(f.rids)]
        for i, rid in enumerate(f.rids):
            check(np.array_equal(by_rid[rid].doc_ids, served_ids[i]),
                  f"queue flush at {f.flush_s:.4f} s: request {rid} differs from saat_search "
                  f"at rho {f.rho}")
    waits = summarize_latencies([c.wait_ms for c in comps])
    ids = np.stack([by_rid[i].doc_ids for i in range(QUEUE_REQUESTS)])
    rels = np.asarray(qrels)[order]
    reasons = {r: sum(1 for f in queue.flush_log if f.reason == r) for r in ("full", "deadline", "drain")}
    served = {}
    for c in comps:
        served[str(c.rho)] = served.get(str(c.rho), 0) + 1
    by_rho = {}
    for rho in served:
        pick = [c.rid for c in comps if str(c.rho) == rho]
        by_rho[rho] = mrr_at_k(ids[pick], rels[pick], 10)
    rr = mrr_at_k(ids, rels, 10)
    rr_exact = mrr_at_k(exact_ids, rels, 10)
    span = comps[-1].flush_s - arrivals[0] if comps else 0.0
    print(f"queue serving: {QUEUE_REQUESTS} requests at {QUEUE_QPS:.0f} qps, deadline "
          f"{QUEUE_DEADLINE_MS} ms, buckets {buckets}, shapes {QUEUE_SHAPES}; warm-up {warm_s:.1f} s, "
          f"replay {replay_s:.2f} s (clock span {span:.3f} s); {len(queue.flush_log)} flushes "
          f"{reasons}; violations {queue.n_violations}, infeasible {queue.n_infeasible}, degraded "
          f"flushes {queue.n_degraded}; served rho (requests) {served}; MRR@10 by served rho "
          f"{json.dumps({k: round(v, 4) for k, v in by_rho.items()})}; RR@10 {rr:.4f} (the "
          f"same requests at the exact level: {rr_exact:.4f})")
    print(f"queue serving: wait {latency_line(waits)}; launches {launches}; every completion "
          f"equals saat_search on its flush at its rho")


DAAT_SERVED = (("fused", 1), ("multi", 8))


def serve_daat_phase(index, qt_np, qw_np) -> None:
    """DAAT through ``AnytimeServer`` (kernels, fused chunk; then 8 trips per
    launch): every batch's result, WorkStats included, equal to
    ``daat_search_batched`` called directly."""
    mb = max_blocks_per_term(index)
    for mode, trips in DAAT_SERVED:
        cfg = ServingConfig(engine="daat", k=SERVE_K, batch_size=BATCH, daat_use_kernels=True,
                            daat_fused_chunk=True, daat_trips_per_launch=trips)
        server = AnytimeServer(index, cfg)
        server.warmup(qt_np[:BATCH], qw_np[:BATCH])
        server.reset_stats()
        served = []
        real = server.search_batch

        def capture(q_terms, q_weights, rho=None, real=real, served=served):
            res = real(q_terms, q_weights, rho=rho)
            served.append(res)
            return res

        server.search_batch = capture
        reset_launches()
        run_query_stream(server, qt_np, qw_np)
        launches = read_launches()
        need = ["block_prune_csr", "block_topk", "sparse_score",
                "chunk_step" if trips == 1 else "chunk_step_multi"]
        for name in need:
            check(launches[name] > 0, f"DAAT served {mode}: kernel {name} was not launched")
        for (lo, bt, bw), res in zip(host_batches(qt_np, qw_np, BATCH), served, strict=True):
            want = daat_search_batched(index, bt, bw, k=SERVE_K, max_bm_per_term=mb,
                                       use_kernels=True, fused_chunk=True, trips_per_launch=trips,
                                       **DAAT_KW)
            for field in DaatResult._fields:
                check(torch.equal(getattr(res, field), getattr(want, field)),
                      f"DAAT served {mode} batch@{lo}: {field} differs from daat_search_batched")
        stats = server.stats()
        chunks = torch.cat([r.chunks for r in served]).float()
        print(f"DAAT served {mode}: per-query latency {latency_line(stats)}; trips mean "
              f"{float(chunks.mean()):.2f} max {int(chunks.max())}; launches "
              f"{ {n: launches[n] for n in need} }; every batch equals daat_search_batched")


def one_compaction_threshold(events, n_docs) -> int:
    """A delta-size threshold at which the compaction policy fires exactly
    once over the mutation stream: the delta gains a doc with each add and
    update, loses one when a doc in it is deleted, and empties at a
    compaction; adds take gids from ``n_docs`` on, as the handle assigns."""
    def replay(threshold):
        delta, next_gid, peak, fired = set(), n_docs, 0, 0
        for ev in events:
            if ev.op == "add":
                delta.add(next_gid)
                next_gid += 1
            elif ev.op == "update":
                delta.add(ev.gid)
            else:
                delta.discard(ev.gid)
            peak = max(peak, len(delta))
            if len(delta) >= threshold:
                delta, fired = set(), fired + 1
        return peak, fired

    peak, _ = replay(float("inf"))
    threshold = max(2, int(np.ceil(0.6 * peak)))
    check(replay(threshold)[1] == 1, f"no single-compaction threshold at {threshold} (peak {peak})")
    return threshold


def rescore_live(handle, qt, qw, scores, ids, what) -> None:
    """Each returned gid is live and carries its score on the live corpus:
    its row in the delta if it is there, else its (untombstoned) row in
    main, scored by the plain scorer."""
    main, delta = handle.main, handle.delta
    fin = torch.isfinite(scores)
    gid = torch.where(fin, ids, 0).long()
    check(not (set(gid[fin].tolist()) & handle.dead_gids), f"{what}: a tombstoned gid was returned")
    qt = torch.as_tensor(qt, device=main.device)
    qw = torch.as_tensor(qw, device=main.device)
    qvec = query_vectors(main, qt, qw)
    rows = torch.arange(qvec.shape[0], device=qvec.device)[:, None, None]
    in_main = gid < main.doc_terms.shape[0]
    mg = torch.where(in_main, gid, 0)
    want = torch.sum(qvec[rows, main.doc_terms[mg].long()] * main.doc_weights[mg], dim=-1)
    in_delta = torch.zeros_like(fin)
    if delta is not None:
        local_of = {int(g): i for i, g in enumerate(handle.delta_gids.tolist()[:handle.delta_docs])}
        local = torch.tensor([[local_of.get(int(g), -1) for g in row] for row in gid.tolist()],
                             device=gid.device)
        in_delta = local >= 0
        lg = torch.clamp_min(local, 0)
        dwant = torch.sum(qvec[rows, delta.doc_terms[lg].long()] * delta.doc_weights[lg], dim=-1)
        want = torch.where(in_delta, dwant, want)
    live_main = in_main & (handle.live_mask[mg] != 0)
    check(bool((in_delta | live_main)[fin].all()), f"{what}: a returned gid is not live")
    bad = fin & ~near(scores.float(), want)
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} merged ids do not carry their scores "
                               f"on the live corpus")


def churn_phase(index, qt_np, qw_np, seed) -> None:
    """An ``IndexHandle`` over the shard takes ``replay_with_churn`` on a
    simulated clock: queries through the queue (SAAT fused), a seeded
    add/update/delete stream, and a threshold compaction that fires once.
    A fixed batch answers equally just before and just after the fold (SAAT
    fused at the exact level, and DAAT fused); every flush's merged ids
    are live and rescored on the live corpus."""
    handle = IndexHandle(index)
    n_terms = index.n_terms
    buckets = (8, 16, max(16, qt_np.shape[1]))
    clock = SimulatedClock()
    cfg = ServingConfig(k=SERVE_K, rho_ladder=SERVE_LADDER, batch_size=QUEUE_SHAPES[-1],
                        fused_topk=True, lq_buckets=buckets)
    server = AnytimeServer(handle, cfg, clock=clock)
    queue = AdmissionQueue(server, batch_shapes=QUEUE_SHAPES, clock=clock, safety_ms=QUEUE_SAFETY_MS)
    server.warmup(qt_np[:8], qw_np[:8], batch_sizes=QUEUE_SHAPES)
    server.reset_stats()
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / QUEUE_QPS, size=CHURN_REQUESTS))
    order = rng.integers(0, qt_np.shape[0], size=CHURN_REQUESTS)
    mutations = _mutation_schedule(np.random.default_rng(seed + 1), index.n_docs, n_terms,
                                   float(arrivals[-1]), CHURN_MUTATE_QPS)
    threshold = one_compaction_threshold(mutations, index.n_docs)
    bt, bw = qt_np[:BATCH], qw_np[:BATCH]
    checks = {}

    def answers():
        saat = handle.saat_search(bt, bw, k=SERVE_K, fused_topk=True)
        daat = handle.daat_search(bt, bw, k=SERVE_K, use_kernels=True, fused_chunk=True, **DAAT_KW)
        for name, res in (("SAAT", saat), ("DAAT", daat)):
            rescore_live(handle, bt, bw, res.scores, res.doc_ids, f"churn fixed batch {name}")
        return saat, daat

    class CheckedCompactor(Compactor):
        def maybe_compact(self, now_s=None):
            if not self.policy.due(self.handle):
                return False
            before = answers()
            t0 = time.perf_counter()
            done = super().maybe_compact(now_s)
            checks["compact_s"] = time.perf_counter() - t0
            after = answers()
            (bs, bd), (as_, ad) = before, after
            fin = torch.isfinite(bs.scores)
            check(torch.equal(fin, torch.isfinite(as_.scores))
                  and torch.equal(bs.doc_ids[fin], as_.doc_ids[fin]),
                  "churn: SAAT answers differ just before and just after the compaction")
            max_err(as_.scores, bs.scores, "churn: SAAT scores across the compaction")
            checks["daat_swaps"] = tie_swaps(ad.scores, ad.doc_ids, bd.scores, bd.doc_ids,
                                             "churn: DAAT across the compaction")
            checks["generation"] = self.handle.generation
            return done

    real = server.search_batch
    n_flushes = [0]

    def checked(q_terms, q_weights, rho=None):
        res = real(q_terms, q_weights, rho=rho)
        rescore_live(handle, q_terms, q_weights, res.scores, res.doc_ids,
                     f"churn flush {n_flushes[0]}")
        n_flushes[0] += 1
        return res

    server.search_batch = checked
    compactor = CheckedCompactor(queue, handle, CompactionPolicy(max_delta_docs=threshold))
    reset_launches()
    t0 = time.perf_counter()
    comps, mlog = replay_with_churn(
        queue, handle, arrivals.tolist(), [qt_np[i] for i in order], [qw_np[i] for i in order],
        [QUEUE_DEADLINE_MS] * CHURN_REQUESTS, mutations, compactor=compactor)
    replay_s = time.perf_counter() - t0
    launches = read_launches()
    for name in ("impact_scatter_topk", "block_prune_csr", "block_topk", "sparse_score",
                 "chunk_step"):
        check(launches[name] > 0, f"churn: kernel {name} was not launched")
    check(compactor.n_compactions == 1 and handle.generation == 1,
          f"churn: {compactor.n_compactions} compactions, expected exactly one")
    check(sorted(c.rid for c in comps) == list(range(CHURN_REQUESTS)),
          "churn: a request was lost or served twice")
    gens = [f.generation for f in queue.flush_log]
    check(gens == sorted(gens), "churn: flush generations are not monotone")
    ops = {op: sum(1 for m in mlog if m["op"] == op) for op in ("add", "update", "delete")}
    print(f"churn: {CHURN_REQUESTS} requests and {len(mlog)} mutations {ops} over "
          f"{float(arrivals[-1]):.3f} s (simulated); compaction at delta {threshold} docs fired "
          f"once, {checks['compact_s']:.1f} s (host fold and build, then upload); flush "
          f"generations {min(gens)}..{max(gens)} over {len(gens)} flushes; replay "
          f"{replay_s:.1f} s; fixed batch equal across the compaction (DAAT "
          f"{checks['daat_swaps']} ranks differ between near-tied scores); every flush's ids "
          f"live and rescored; launches {launches}")


def vmap_phase(index, qt, qw) -> None:
    """``saat_search_vmap`` with the kernel scatter (the B=1 wrapper, one
    launch per query) on one batch: ids equal to ``saat_search``'s."""
    ms = max_segments_per_term(index)
    reset_launches()
    res = saat_search_vmap(index, qt, qw, k=SERVE_K, rho=1_000_000, max_segs_per_term=ms,
                           scatter_impl="kernel")
    sync()
    launches = scatter_ops.LAUNCHES
    check(launches >= qt.shape[0], f"saat_search_vmap: {launches} impact_scatter launches for "
                                   f"{qt.shape[0]} queries")
    want = saat_search(index, qt, qw, k=SERVE_K, rho=1_000_000, max_segs_per_term=ms,
                       scatter_impl="kernel")
    ids_equal(res.doc_ids, want.doc_ids, "saat_search_vmap vs saat_search")
    check(torch.equal(res.scores, want.scores), "saat_search_vmap: scores differ")
    print(f"saat_search_vmap (kernel) B={qt.shape[0]} rho=1M: {launches} impact_scatter launches "
          f"(B=1 wrapper); ids and scores equal to saat_search")


def single_query_phase(index, qt, qw) -> dict:
    """Each single-query wrapper called once on the batch's first query,
    with its counter set to 0 just before and read just after; each result
    equal bit for bit to the batched wrapper's first row. Returns the
    launches."""
    ms = max_segments_per_term(index)
    mb = max_blocks_per_term(index)
    k, est = SERVE_K, DAAT_KW["est_blocks"]
    docs, contribs, _ = _gather_postings_batched(index, saat_plan(index, qt[:1], qw[:1], ms),
                                                 1_000_000)
    ub = block_upper_bounds(index, qt[:1], qw[:1], mb)
    _, b1 = topk(ub, est)
    rows = (b1.long()[0, :, None] * index.block_size
            + torch.arange(index.block_size, device=ub.device)).flatten()
    dt, dw = index.doc_terms[rows].contiguous(), index.doc_weights[rows].contiguous()
    q_t, q_w = qt[0].int().contiguous(), torch.where(qw[0] > 0, qw[0].float(), 0.0).contiguous()
    saat_kw = dict(block_d=512, tile_p=512)
    calls = {
        "impact_scatter_b1": (
            lambda: (scatter_ops.impact_scatter(docs[0], contribs[0], index.n_docs, **saat_kw),),
            lambda: (scatter_ops.impact_scatter_batched(docs, contribs, index.n_docs,
                                                        **saat_kw)[0],)),
        "impact_scatter_topk_b1": (
            lambda: fused_ops.impact_scatter_topk(docs[0], contribs[0], index.n_docs, k, **saat_kw),
            lambda: tuple(t[0] for t in fused_ops.impact_scatter_topk_batched(
                docs, contribs, index.n_docs, k, **saat_kw))),
        "block_topk_b1": (
            lambda: btopk_ops.block_topk(ub[0], DAAT_KW["block_budget"]),
            lambda: tuple(t[0] for t in btopk_ops.block_topk_batched(ub, DAAT_KW["block_budget"]))),
        "sparse_score_b1": (
            lambda: (score_ops.sparse_score(dt, dw, q_t, q_w),),
            lambda: (score_ops.sparse_score_batched(dt[None], dw[None], q_t[None], q_w[None])[0],)),
    }
    launches = {}
    for name, (single, batched) in calls.items():
        sync()
        reset_launches()
        got = single()
        sync()
        launches[name] = read_launches()[name]
        check(launches[name] > 0, f"kernel {name} was not launched by its single-query wrapper")
        for g, w in zip(got, batched(), strict=True):
            check(torch.equal(g, w), f"{name}: the single-query wrapper differs from the batched one")
    print(f"single-query wrappers: each equal bit for bit to the batched wrapper's first row; "
          f"launches {launches}")
    return launches


class PhaseClock:
    """Seconds of each phase, printed as each ends."""

    def __init__(self):
        self.seconds = {}
        self.t0 = time.perf_counter()

    def end(self, name: str) -> None:
        t = time.perf_counter()
        self.seconds[name] = t - self.t0
        print(f"[phase {name}: {t - self.t0:.1f} s]")
        self.t0 = t


def run(args, device) -> None:
    t_start = time.perf_counter()
    phase = PhaseClock()
    card = gpu_name_and_limit()
    print(card)
    t0 = time.perf_counter()
    logs = common.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    phase.end("kernel build")

    err_s, err_t = contract_phases(device, args.seed)
    scatter_edge_phases(device, args.seed)
    daat_errs = daat_contract_phases(device, args.seed)
    phase.end("kernel contracts")
    corpus, data = make_data(args.n_docs, args.n_queries, args.seed, device)
    phase.end("corpus and index builds")
    index, qt, qw = data[MAIN_SHAPE[0]]
    rng = np.random.default_rng(args.seed)
    live = torch.as_tensor(rng.random(index.doc_terms.shape[0]) < 0.9, dtype=torch.int32,
                           device=device)
    rows = main_shape_phases(index, qt[:BATCH], qw[:BATCH], live)
    rows.update(daat_main_shape_phases(index, qt[:BATCH], qw[:BATCH], live))
    phase.end("kernels at the main shapes")
    torch.cuda.reset_peak_memory_stats()  # the peak below is the paths', not the graph timings'

    # the SAAT path
    serve(data, n_batches=1)  # warm-up: allocator and sort workspaces at every shape
    reset_launches()
    results, latency = serve(data)
    launches = read_launches()
    print(f"SAAT main path launches: {launches}")
    for name in SAAT_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the SAAT main path")

    rr = verify(data, results, corpus.qrels)
    for key, v in rr.items():
        print(f"RR@10 {key}: {v:.4f}")
    for (m, k, rho, route), v in latency.items():
        print(f"batch latency {m} k={k} rho={rho} {route}: median {np.median(v):.3f} ms, "
              f"max {max(v):.3f} ms over {len(v)} batches (B={BATCH}, host clock)")
    profile_batch(index, qt[:BATCH], qw[:BATCH], MAIN_SHAPE[1], MAIN_SHAPE[2])
    phase.end("SAAT path")

    # the DAAT path: every batch in every mode, then one batch under the
    # tombstone bitmap in the fused and multi-trip modes (and plain, to
    # hold them against)
    live_modes = tuple(mm for mm in DAAT_MODES if mm[0] in ("plain", "fused", "multi"))
    live_runs = ((10, True),)
    serve_daat(data, n_batches=1)  # warm-up, one batch per configuration
    serve_daat(data, n_batches=1, live=live, runs=live_runs, modes=live_modes)
    reset_launches()
    d_results, d_latency, d_syncs = serve_daat(data)
    l_results, l_latency, _ = serve_daat(data, n_batches=1, live=live, runs=live_runs,
                                         modes=live_modes)
    d_launches = read_launches()
    print(f"DAAT main path launches: {d_launches}")
    for name in DAAT_KERNELS:
        check(d_launches[name] > 0, f"kernel {name} was not launched on the DAAT main path")
    check(d_launches["sparse_score_b1"] == 0,
          "the DAAT main path launched the gathered-rows scorer: split mode gathered rows")
    launches.update({name: d_launches[name] for name in DAAT_KERNELS})

    verify_daat(data, d_results)
    verify_daat(data, l_results, runs=live_runs, live=live, modes=("fused", "multi"))
    daat_stats(data, d_results)
    for (m, k, exact, mode), v in d_latency.items():
        sy = d_syncs.get((m, k, exact, mode))
        print(f"DAAT batch latency {m} k={k} exact={exact} {mode}: median {np.median(v):.3f} ms, "
              f"max {max(v):.3f} ms over {len(v)} batches (B={BATCH}, host clock)"
              + (f"; host syncs per batch {sy}" if sy else ""))
    for (m, k, exact, mode), v in l_latency.items():
        print(f"DAAT batch latency {m} k={k} exact={exact} {mode} live: {v[0]:.3f} ms "
              f"(one batch, B={BATCH}, host clock)")
    profile_daat_batch(index, qt[:BATCH], qw[:BATCH], 10)
    phase.end("DAAT path")

    # the dense prune's oracle path, then serving on the spladev2 shard
    dense_rows, dense_launches = dense_prune_phase(index, qt[:BATCH], qw[:BATCH], device, args.seed)
    rows.update(dense_rows)
    launches.update(dense_launches)
    phase.end("dense block_prune")
    qt_np, qw_np = qt.cpu().numpy(), qw.cpu().numpy()
    qrels = np.asarray(corpus.qrels)
    serve_direct(index, qt_np, qw_np, qrels)
    phase.end("direct serving")
    serve_queue(index, qt_np, qw_np, qrels, args.seed)
    phase.end("queue serving")
    serve_daat_phase(index, qt_np, qw_np)
    phase.end("DAAT served")
    churn_phase(index, qt_np, qw_np, args.seed)
    phase.end("churn")
    vmap_phase(index, qt[:BATCH], qw[:BATCH])
    phase.end("saat_search_vmap")
    launches.update(single_query_phase(index, qt[:BATCH], qw[:BATCH]))
    for name, batched in SINGLE_KERNELS.items():
        rows[name] = [r for r in rows[batched] if r["what"].startswith("main B=1")]
    phase.end("single-query wrappers")
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    errs = {
        "impact_scatter": max([err_s] + [r["max_abs_err"] for r in rows["impact_scatter"]]),
        "impact_scatter_topk": max([err_t] + [r["max_abs_err"] for r in rows["impact_scatter_topk"]]),
    }
    errs.update({n: max([daat_errs[n]] + [r["max_abs_err"] for r in rows[n]]) for n in DAAT_KERNELS})
    errs.update({n: 0.0 for n in ("block_prune", "block_prune_b1")})  # equal bit for bit
    errs.update({n: max(r["max_abs_err"] for r in rows[n]) for n in SINGLE_KERNELS})
    kernels = [
        {"name": name, "route": "cuda", "source": kern.source, "replaces": kern.replaces,
         "launches": launches[name], "max_abs_err": errs[name], "ms": rows[name][0]["ms"],
         "plain_ms": rows[name][0]["plain_ms"], "bound_ms": rows[name][0]["bound_ms"],
         "bound_by": "bytes", "library_ms": rows[name][0]["library_ms"],
         "graph_ms": rows[name][0]["graph_ms"],
         "library_graph_ms": rows[name][0]["library_graph_ms"]}
        for name, kern in KERNELS.items()
    ]
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase.seconds.items()})}")
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
