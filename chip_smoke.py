#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --saat-cell [--seed N]

It needs one CUDA card and exits non-zero without one. ``--saat-cell`` runs
only ``saat_cell_phase``: ``impact_scatter_topk``'s segment entry at the
shapes of the ``spladev2-saat-open`` benchmark cell, on that cell's
deployment built from the seed (B = 8 and 32 pool queries and a flush of 16
requests padded to 32 rows, at rho = 1M, with and without tombstones), bit
for bit against its plain version, the ``[B, P]`` entry and the gathered
route, timed beside that route, with both routes' peak memory and the
segment entry's CTA layouts swept. Without it, in order:

1. builds every CUDA kernel from ``src/repro_torch/csrc`` (``nvcc``, sm_90a,
   one process per source, all at once) and prints the build time and the
   compiler's register report;
2. kernel phases at the contract shapes (each kernel package's ``CONTRACT``:
   the reference's cases and the port's edges): each kernel, and each
   single-query (B=1) wrapper, held against its plain PyTorch version run
   on a host copy of its inputs; both scatter kernels bit for bit at their
   edges (an empty block, a range over three shared-memory stages, a block
   of tombstoned docs, pad docs, tied scores, k_blk = 1, 10, 16, 32, 33 and
   512 across the select-or-sort rule); ``impact_scatter`` also at its
   range edges (a run across every range boundary, runs longer than a range
   and its read-past, an empty row, postings only on the first or the last
   doc, doc spans of thousands of docs, real postings that end on a range
   boundary) at every layout; ``impact_scatter_topk``'s segment entry (the
   engine's fused route, which reads the plan) at its contract's cases in
   the static analysis below; ``block_prune_csr`` bit for bit at its edges
   (blocks on both sides of every tile boundary, B = 1, 63 and 64 at the
   engine's widths, a window cut at the end of the lists, all pad slots, NB
   not a multiple of the tile, one block) at every tile it is swept over;
3. generates one shard of a 32-way document-sharded MS MARCO passage
   deployment (276,307 docs, 256 queries) under the ``spladev2`` and
   ``bm25`` treatments, builds each impact index on the host and places it
   on the card;
4. kernel phases at the main paths' shapes (one 64-query ``spladev2``
   batch; with and without a tombstone bitmap), held against the plain
   versions as above and timed with CUDA events beside the plain version
   and a library yardstick where one PyTorch call computes the same; the
   kernel and the yardstick also as 50 calls replayed from one CUDA graph,
   which leaves out the host's launch cost, and for ``impact_scatter`` and
   the dense ``block_prune`` also cold (the graph's calls rotate over copies
   of their inputs that the L2 cannot hold) and, at B = 1, the host's
   enqueue time a launch; ``impact_scatter`` at rho = 1M and 100k, B = 64,
   63 and 1, with its layout (slots a range, ranges a CTA) swept at B = 64
   and rho = 1M; ``block_topk`` and
   ``chunk_step`` also at their edges (ties, all--inf rows, ragged widths,
   B = 1 and 63, k = 1000, tombstones, rows that leave a multi-trip launch
   at different trips); ``sparse_score``'s store-addressed entry at the
   split trip's shape and phase 1's, and bit for bit at its edges (integer
   weights: B = 1 and 63, tombstones, the ragged last block, rows with no
   padding or no terms, duplicate query terms, the live-block gate), with a
   sweep of its docs per CTA and a check that a split batch scores through
   it and makes no [B, N, Tmax] gather; ``impact_scatter_topk``'s select
   and sort timed against each other at k_blk = 10, 32 and 64; its segment
   entry bit for bit against its plain version and against the ``[B, P]``
   entry's pool on the gathered, sorted postings, timed beside the gather,
   the sort and the ``[B, P]`` launch it replaces, and its CTA layouts (docs
   a CTA, threads) swept at B = 64;
   ``block_prune_csr`` at B = 64, 63 and 1 of the batch, and its tiles swept
   at B = 64;
5. the static analysis (``repro_torch.analysis`` on the card,
   ``analysis_phase``): every kernel package's ``CONTRACT`` at each of its
   cases, each launched, the wrapper under the CUDA sync debug mode's
   "error"; every Python launch plan equal to its source's C
   ``<launcher>_plan``; ptxas's registers and static shared memory per
   kernel against the plans; the SASS's ``LDGSTS`` exactly where a contract
   expects async copies, each with a ``DEPBAR`` after it; the serving lint
   (the eight server configs, the handle across a compaction, the sharded
   step at (1, 1) and the pod step at (2, 2)), each route's host reads held
   to its budget and equal to the sync debug mode's count; then the lint
   once per route on the 64-query batch (SAAT fused and kernel at 1M and
   exact, DAAT split, fused and 8 trips a launch), reads equal to each
   budget; zero violations, or the run fails;
6. the SAAT path: after one warm-up batch per configuration, serves the
   256 queries in batches of 64 through ``saat_search`` with the fused
   kernel and with the scatter kernel, at k=10 for rho in {100k, 1M,
   exact} and at k=1000 for rho=1M, and holds every result against the
   plain ``"sort"`` mode on the card (and ``exhaustive_search`` at exact
   rho); prints RR@10, batch latencies and a profiled batch;
7. the DAAT path: the same batches through ``daat_search_batched`` in the
   plain, split (``use_kernels``), fused (``fused_chunk``) and multi-trip
   (``trips_per_launch=8``) modes at (k=10, exact), (k=10, approximate)
   and (k=1000, exact), and one batch under the tombstone bitmap; the
   kernel modes must agree exactly, the plain mode within tolerance and
   with equal ``WorkStats`` (but at near-ties, printed), and exact results
   must be rank-safe and match ``exhaustive_search``; prints the work
   counts, batch latencies, host syncs and a profiled batch;
8. the weight analysis (``core/wacky.py``): ``full_report`` of both
   shards over every query at k = 10, one line each, its bounds (one
   ``block_prune_csr`` launch a shard) equal bit for bit to
   ``block_upper_bounds``; then ``frontier_table`` (``core/pareto.py``) of
   the SAAT rho levels and DAAT modes measured above;
9. the trainable encoder (``encoder_phase``), in f32 with TF32 off: at
   ``tests/test_e2e.py``'s size, both heads on the card against the CPU from
   the same params and batches (the encoding, with each side's distance
   from an f64 run on the host, step 0's loss and gradients, 5 steps'
   losses); at DistilBERT's widths on the shard corpus's 48,064
   terms, 2 warm-up and 20 timed steps (ms a step, triples/s, model FLOPs
   and their share of the f32 peak, peak memory, the loss), 2,048 docs
   encoded to postings, and a checkpoint of the train state written and
   restored bit for bit; then ``launch/train_encoder.py``'s ``main`` at the
   example's settings but 150 of its 300 steps (train, encode, index, SAAT
   against BM25) and its
   learned index's queries through ``impact_scatter_topk`` and
   ``impact_scatter`` against the plain sort mode; then the model families
   (``arch_phase``, plain PyTorch): every arch of ``repro_torch.configs``
   at its smoke size on the card against the CPU (step 0's loss and
   gradients; the LMs' prefill and decode logits; the recsys models'
   ``retrieve_topk``), ``launch/train.py``'s ``main`` at the published
   widths of gemma3-1b (B = 2, 2,048 tokens: the 1,024 windows bite) and
   granite-moe-3b-a800m (40 experts, top-8; the share of routes dropped),
   GraphCast at ``full_graph_sm`` in bf16 (against the card's f32 run, and
   its train state's checkpoint restored bit for bit), dcn-v2 at 65,536
   rows with its full tables, ``retrieve_topk`` of dcn-v2 and sasrec over
   1,000,448 candidates against a full sort, and gemma3-1b's prefill of
   2,048 tokens and 32 decode steps against the full forward (f32), timed
   in bf16 at B = 2 and 32; then the sharding half of the distribution
   layer (``sharding_phase``, plain PyTorch): the dry-run's plan of every
   cell at both production meshes (72 plans, 8 skipped cells, one line
   each under the H100's peaks), gemma3-1b's train state at its published
   widths placed in process on a (data 2, model 4) mesh (each rank's bytes
   what ``train_state_shardings`` gives, reassembled bit for bit), copied
   to the host and placed again by ``reshard_state`` on
   ``best_effort_mesh``'s mesh for this machine's devices (bit for bit),
   three steps with ``make_error_feedback_transform`` as the trainer's
   ``grad_transform`` against three without (every leaf's compression
   error within half a quantization step), ``compressed_psum`` and
   ``reduce_scatter_grads`` at 4 ranks in process on gemma3-1b-sized
   gradients (the int8 bound; the rank-ordered sum's slices bit for bit),
   the three collectives over an NCCL process group of one rank (equal to
   the in-process path at one rank; liveness 1), and ``shard_batch`` of a
   train batch;
10. the dense ``block_prune`` on its oracle path: at the reference's
   contract shapes and its edges (the engine's widths at B = 63 and 1, an
   Lq of several rounds of loads, one block) against its plain version at
   every tile, then on one 64-query
   ``spladev2`` batch ``_dense_blockmax_rows`` and the kernel, with theta
   the batch's DAAT k-th scores, ub equal bit for bit to ``block_prune_csr``
   and to the plain version; timed beside the plain version and
   ``torch.bmm``, hot and cold, with its tile swept at B = 64 and 1;
11. serving on the ``spladev2`` shard: ``AnytimeServer`` directly (SAAT,
   fused kernel, the CLI's rho ladder, a deadline under the top level's
   calibrated cost, every batch equal to ``saat_search`` at the rho served,
   the ``--eval-qrels`` sweep); through the admission queue on a
   ``HybridClock`` at the CLI's defaults (1,024 Poisson arrivals, each
   completion equal to ``saat_search`` on its flush); DAAT served in the
   fused and 8-trip modes (equal to ``daat_search_batched``); an
   ``IndexHandle`` under ``replay_with_churn`` with one compaction (answers
   equal across it, every merged id live and rescored); and
   ``saat_search_vmap`` with the kernel scatter;
12. doc-sharded serving: the ``spladev2`` corpus re-sharded 4 ways with
   ``shard_corpus`` and stacked on the card; the pod step at (pod = 2,
   model = 2) and the sharded step at (1, 1) with all 4 shards on one
   rank, SAAT through both scatter kernels and DAAT fused, against the
   unsharded engines (near-ties checked) and each other (bit for bit); the
   (1, 1) step over an NCCL process group of one rank, bit for bit; the
   tombstone bitmap through ``shard_live_stack``; a ``PodFrontEnd`` of 2
   hosts at the queue's settings, each completion equal to the pod step at
   its rho; then, printed, the pod step's latency, each shard's engine time
   (SAAT at 250k and exact, DAAT with its trips), RR@10 at 4 x 250k and
   the merge's time;
13. the single-query wrappers (B = 1) of the scatter, fused top-k, block
   top-k and scoring kernels, each called once on a query of the batch.

Each path runs with the launch counters set to 0 just before and read just
after, and fails if one of its kernels was not launched. It prints each
phase's seconds; last the card's name and power limit, one
``{"kernels": [...]}`` JSON line, and the ``{"ok": true, ...}`` line.

Any mismatch raises, so the run exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import copy
import dataclasses
import gc
import importlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import namedtuple
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.analysis import check as analysis_check  # noqa: E402
from repro_torch.analysis.hot_path import (  # noqa: E402
    daat_budget,
    lint_route,
    saat_budget,
)
from repro_torch.analysis.kernel_contracts import (  # noqa: E402
    REGISTERS_PER_SM,
    all_contracts,
    c_launch_plan,
    python_launch_plan,
)
from repro_torch.analysis.op_trace import find_kernel_calls  # noqa: E402
from repro_torch.archs import layers as arch_layers  # noqa: E402
from repro_torch.archs.gnn import (  # noqa: E402
    abstract_gnn_params,
    gnn_forward,
    gnn_loss,
    init_gnn_params,
)
from repro_torch.archs.gnn import train_step_model_flops as gnn_train_flops  # noqa: E402
from repro_torch.archs.recsys import init_params as init_recsys_params  # noqa: E402
from repro_torch.archs.recsys import retrieve_topk, score_candidates  # noqa: E402
from repro_torch.archs.recsys import train_step_model_flops as recsys_train_flops  # noqa: E402
from repro_torch.archs.transformer import (  # noqa: E402
    decode_step_model_flops,
    init_lm_params,
    lm_decode_step,
    lm_hidden_states,
    lm_logits,
    lm_prefill,
    train_step_model_flops,
)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DaatResult,
    OperatingPoint,
    QuantConfig,
    block_upper_bounds,
    build_impact_index,
    csr_blockmax_offsets,
    daat_plan,
    daat_search_batched,
    exhaustive_search,
    frontier_table,
    max_blocks_per_term,
    max_segments_per_term,
    pad_queries,
    query_vector,
    query_vectors,
    saat_plan,
    saat_search,
    score_all_docs,
    score_blocks,
    wacky,
)
from repro_torch.core.daat import _dense_blockmax_rows, _mask_dead_blocks  # noqa: E402
from repro_torch.core.index_handle import IndexHandle  # noqa: E402
from repro_torch.core.saat import _gather_postings_batched, saat_search_vmap  # noqa: E402
from repro_torch.configs import ARCHS, batch_specs  # noqa: E402
from repro_torch.core.topk import canonical_topk_merge, topk  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    TripleSampler,
    gnn_batches,
    lm_token_batches,
    recsys_batches,
    shard_batch,
)
from repro_torch.data.synthetic import CorpusConfig, generate_corpus  # noqa: E402
from repro_torch.distributed import collectives, elastic, make_mesh  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch import train_encoder  # noqa: E402
from repro_torch.launch.serve import _mutation_schedule  # noqa: E402
from repro_torch.metrics.ir_metrics import (  # noqa: E402
    cheapest_rho_within_loss,
    mrr_at_k,
    rho_effectiveness_sweep,
)
from repro_torch.metrics.latency import HybridClock, SimulatedClock, summarize_latencies  # noqa: E402
from repro_torch.models.sparse_encoder import (  # noqa: E402
    SparseEncoderConfig,
    encode,
    encode_corpus_to_coo,
    encoder_backbone,
    encoder_loss,
    init_encoder_params,
)
from repro_torch.models.treatments import apply_treatment  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionQueue,
    AnytimeServer,
    CompactionPolicy,
    Compactor,
    PodFrontEnd,
    ServingConfig,
    effective_lq,
    make_pod_serve_step,
    make_sharded_serve_step,
    pad_to_width,
    rank_block,
    replay_arrivals,
    replay_with_churn,
    run_query_stream,
    sentinel_rows,
    shard_corpus,
    shard_live_stack,
    stack_indexes,
    warmup_pod,
)
from repro_torch.serving.sharded import _index_data_dict, _local_index  # noqa: E402
from repro_torch.train import (  # noqa: E402
    AdamWConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
    train_loop,
)
from repro_torch.train.tree import flatten_with_paths, tree_map  # noqa: E402

# MS MARCO passage v1 holds 8,841,823 passages; one shard of 32.
N_DOCS = 276_307
N_QUERIES = 256
BATCH = 64
TREATMENTS = ("spladev2", "bm25")
RUNS = ((10, 100_000), (10, 1_000_000), (10, "exact"), (1000, 1_000_000))
MAIN_SHAPE = ("spladev2", 10, 1_000_000)  # the (treatment, k, rho) the kernels line reports
RTOL, ATOL = 1e-5, 1e-6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
L2_BYTES = 50e6  # H100 L2 cache: cold timings rotate over copies of twice this
SCATTER_RHOS = (1_000_000, 100_000)  # B2's main shapes, beside B = 64 and 1
# B1's segment entry: the CTA layouts (docs a CTA, threads) its sweep times,
# and the ``spladev2-saat-open`` benchmark cell whose shapes ``--saat-cell``
# checks it at (B = 8 and 32, and a flush of 16 requests padded to 32 rows)
SEGMENT_SWEEP = tuple((d, t) for d in (4096, 8192, 16384) for t in (256, 512, 1024)
                      if 4 <= d // t <= 32)
SAAT_CELL_CONFIG = Path(__file__).resolve().parent / "portbench/configs/msmarco-v1-spladev2-shard32.json"
SAAT_CELL_RHO, SAAT_CELL_K = 1_000_000, 10
# B1's block top-k by the select and by the sort, swept at B = 64: either side
# of the rule's switch (the edge phases hold k_blk 1 and 16 bit for bit)
SELECT_SWEEP_KS = (10, 32, 64)

# The kernels' shapes, read from each kernel package's CONTRACT (its
# reference cases, port=False, and the port's own edges, port=True), the
# one source of shapes of these phases and of repro_torch.analysis.
SCATTER_CASES = scatter_ops.CONTRACT.cases(port=False)
TOPK_CASES = fused_ops.CONTRACT.cases(port=False)
# The scatter kernels at their edges (scatter_edge_inputs): 8 blocks of 512,
# the last ragged; k_blk on both sides of fused_ops.SELECT_MAX_K and at block_d.
SCATTER_EDGE = dict(scatter_ops.CONTRACT.cases(port=True))["edge"]
SCATTER_EDGE_KS = tuple(fused_ops.CONTRACT.sweep_values("k", require=("empty",)))
PRUNE_CASES = prune_ops.CONTRACT.cases(port=False)
# block_prune_csr at its edges (prune_inputs): lists holding the blocks on
# both sides of every boundary of 32-block tiles (so of every swept tile),
# the engine's widths (Lq 35, 2,159 blocks) at B = 1, 63 and 64, NB not a
# multiple of the tile, a window cut at the end of the lists, all pad
# slots, one block; each at every tile of the sweep and the wrapper's.
PRUNE_EDGE_CASES = prune_ops.CONTRACT.cases(port=True)
PRUNE_SWEEP_TILES = (32, 64, 128, 256, 512, 1024, 2048)  # blocks a CTA
BTOPK_CASES = btopk_ops.CONTRACT.cases(port=False)
# block_topk at its edges: the engine's [64, 2159] bounds fully tied, with
# every k it uses and k = 1; a row of all -inf; widths that are not a
# multiple of 32; k past n; B = 1.
BTOPK_EDGE_CASES = btopk_ops.CONTRACT.cases(port=True)
SCORE_CASES = score_ops.CONTRACT.cases(port=False)
# sparse_score's store-addressed entry at its edges (store_inputs): the split
# trip's widths (16 blocks of 128 a query, Tmax 650, Lq 35) on a small store
# whose last 45 docs are pad docs. (Its plain version takes about 20 s on one
# CPU thread, so the contract holds a smaller store case.)
STORE_EDGE = dict(n_blocks=24, block_size=128, tmax=650, vocab=3000, batch=64, lq=35, nb=16)
CHUNK_CASES = chunk_ops.CONTRACT.cases()
DENSE_PRUNE_CASES = dense_prune_ops.CONTRACT.cases(port=False)
# B8 at its edges: the engine's widths at B = 63 and 1, an Lq of several
# rounds of loads (300 slots), one block.
DENSE_PRUNE_EDGE_CASES = dense_prune_ops.CONTRACT.cases(port=True)

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

# Doc-sharded serving: the spladev2 shard re-sharded 4 ways (one card's
# worth of a document-sharded deployment), served by the pod step at 2
# ingestion hosts of 2 ranks, and by one rank holding all 4 shards
SHARDS = 4
POD_LAYOUT = (2, 2)  # (pod, model)
SHARD_RHO = 250_000  # a shard's budget: 4 x 250k against the unsharded 1M
POD_REQUESTS = 256

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
    # the [B, P] entry is the Pallas kernel's counterpart and the engine's
    # fused route no longer calls it: it runs in the kernel phases and the
    # B=1 wrapper only; the engine's fused route launches the segment entry
    "impact_scatter_topk": Kernel(fused_ops, "LAUNCHES", "src/repro_torch/csrc/impact_scatter_topk.cu",
                                  "src/repro/kernels/impact_scatter_topk/kernel.py:229", "pool"),
    # the counterpart of the same Pallas kernel on the engine's fused route,
    # with the [B, rho] gather and the doc sort before it
    "impact_scatter_topk_segments": Kernel(
        fused_ops, "PLAN_LAUNCHES", "src/repro_torch/csrc/impact_scatter_topk.cu",
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


def cold_ms(call, inputs: tuple) -> float:
    """Mean device time of ``call(*inputs)`` where the L2 cannot hold the
    inputs: the calls of one CUDA graph rotate over copies of them, at least
    two and enough that twice the L2's bytes lie between two uses of a
    copy."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = max(2, int(np.ceil(2 * L2_BYTES / max(nbytes, 1))))
    sets = [tuple(t.clone() for t in inputs) for _ in range(copies)]
    sync()
    calls = [lambda a=a: call(*a) for a in sets] * max(1, -(-50 // copies))
    for c in calls[:copies]:
        c()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph, sets
    return start.elapsed_time(end) / len(calls)


def host_us(fn, n: int = 1000, reps: int = 7) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue: ``n`` calls timed
    with ``time.perf_counter``, no synchronise inside; the median of
    ``reps`` such runs (the host is shared). Only for a call whose device
    time is under its host time, so the device is not the limit."""
    fn()
    sync()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / n)
        sync()
    return float(np.median(runs))


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


def max_err(got: torch.Tensor, want: torch.Tensor, what: str, rtol: float = RTOL,
            atol: float = ATOL) -> float:
    """Scores agree within rtol/atol (-inf where and only where the plain
    version has -inf). Returns the largest absolute difference."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()), f"{what}: -inf pattern differs")
    if not bool(fin.any()):
        return 0.0
    diff = (got[fin] - want[fin]).abs()
    bad = diff > atol + rtol * want[fin].abs()
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

        def kernel():
            return scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, block_d)

        def library():
            acc = torch.zeros((B, n_docs_pad + 1), device=docs.device)
            return acc.scatter_add_(1, docs_long, c)

        row.update(
            **timings(kernel, lambda: scatter_ref.impact_scatter_batched_ref(docs, c, n_docs_pad),
                      library),
            cold_ms=cold_ms(lambda d, v: scatter_ops.impact_scatter_launch(d, v, n_docs_pad,
                                                                           block_d), (docs, c)),
            bound_ms=1e3 * (8 * n_real + 4 * B * n_docs_pad) / HBM_BYTES_PER_S,
            postings=n_real, shape=[B, int(docs.shape[1]), n_docs_pad],
            layout=scatter_ops.range_layout(B, int(docs.shape[1]), n_docs_pad,
                                            common.sm_count(docs.get_device())),
        )
        if B == 1:
            row.update(host_us=host_us(kernel), library_host_us=host_us(library))
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


def segments_phase(index, plan, rho, k, live, timed, what):
    """impact_scatter_topk's segment entry on a batch's plan: its pool bit
    for bit against its plain version on a host copy of the plan and the
    posting store, and against the ``[B, P]`` entry's pool on the gathered,
    doc-sorted postings (the route it replaced); timed beside its plain
    version and that route (``gathered_ms``)."""
    block_d = 512
    n_docs = index.doc_terms.shape[0]
    n_docs_pad = common.round_up(max(n_docs, block_d), block_d)
    k_blk = min(k, n_docs, block_d)
    live_pad = None
    if live is not None:
        live_pad = common.pad_axis(live.to(torch.int32), 0, n_docs_pad)[:n_docs_pad].contiguous()
    seg = (index.doc_ids, plan.starts, plan.contribs, plan.cum_len)
    lim = min(rho, 2**31 - 1)

    def kernel():
        return fused_ops.impact_scatter_topk_segments_launch(*seg, lim, n_docs_pad, index.n_docs,
                                                             k_blk, block_d, live_pad)

    def gathered():
        d, c, _ = _gather_postings_batched(index, plan, min(rho, max_total))
        d, c = common.sorted_posting_tiles(d, c, n_docs_pad, 512)
        return fused_ops.impact_scatter_topk_launch(d, c, n_docs_pad, index.n_docs, k_blk,
                                                    block_d, live_pad)

    max_total = int(plan.total_postings.max())
    gs, gi = kernel()
    ws, wi = fused_ref.impact_scatter_topk_segments_ref(
        *(t.cpu() for t in seg), lim, n_docs_pad, index.n_docs, k_blk, block_d,
        None if live_pad is None else live_pad.cpu())
    ps, pi = gathered()
    sync()
    check(torch.equal(gi.cpu(), wi) and torch.equal(gs.cpu(), ws),
          f"impact_scatter_topk_segments {what}: the pool differs from its plain version")
    check(torch.equal(pi, gi) and torch.equal(ps, gs),
          f"impact_scatter_topk_segments {what}: the pool differs from the [B, P] entry's")
    row = {"what": what, "max_abs_err": 0.0}
    if timed:
        B, C = plan.cum_len.shape
        cum = plan.cum_len.long()
        prev = torch.nn.functional.pad(cum[:, :-1], (1, 0))
        limit = torch.clamp_max(cum[:, -1:], lim)
        processed = int(torch.clamp_min(torch.minimum(cum, limit) - prev, 0).sum())
        columns = int(((prev < limit) & (cum > prev)).sum())
        row.update(
            **timings(kernel, lambda: fused_ref.impact_scatter_topk_segments_ref(
                *seg, lim, n_docs_pad, index.n_docs, k_blk, block_d, live_pad), plain_iters=2),
            gathered_ms=cuda_ms(gathered),
            bound_ms=1e3 * (4 * processed + 12 * columns + 8 * B * (n_docs_pad // block_d) * k_blk
                            + (4 * n_docs_pad if live_pad is not None else 0)) / HBM_BYTES_PER_S,
            postings=processed, columns=columns, shape=[B, C, n_docs_pad, k_blk])
    return row


def segments_sweep(index, plan, what) -> None:
    """B1's segment entry at each CTA layout of ``SEGMENT_SWEEP`` (rho = 1M,
    k = 10), replayed from a CUDA graph; every pool equal to the wrapper's
    own layout's."""
    n_docs_pad = common.round_up(max(index.doc_terms.shape[0], 512), 512)
    seg = (index.doc_ids, plan.starts, plan.contribs, plan.cum_len)

    def kernel():
        return fused_ops.impact_scatter_topk_segments_launch(
            *seg, SAAT_CELL_RHO, n_docs_pad, index.n_docs, min(10, index.n_docs), 512)

    chosen = fused_ops.segments_layout
    want = kernel()
    times = {}
    try:
        for cta_docs, threads in SEGMENT_SWEEP:
            fused_ops.segments_layout = lambda n, c=cta_docs, t=threads: chosen(n, c, t)
            if fused_ops.segments_layout(n_docs_pad)["smem"] > common.SMEM_LIMIT:
                continue
            got = kernel()
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"impact_scatter_topk_segments {what} at {cta_docs}/{threads}: the pool differs")
            times[f"{cta_docs}/{threads}"] = graph_ms(kernel, 20)
    finally:
        fused_ops.segments_layout = chosen
    lay = chosen(n_docs_pad)
    print(f"  impact_scatter_topk_segments layout sweep {what}: ms (CUDA graph) by docs a CTA/"
          f"threads {json.dumps(times)}; the wrapper takes {lay['cta_docs']}/{lay['threads']}, "
          f"the fastest {min(times, key=times.get)}")


def peak_above(fn) -> int:
    """Bytes ``fn()`` allocates on the card at its peak above what was
    allocated before it."""
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    return torch.cuda.max_memory_allocated() - base


def saat_cell_phase(seed: int, device) -> None:
    """B1's segment entry at the shapes of the ``spladev2-saat-open``
    benchmark cell: its deployment (``portbench``'s generator, from
    ``seed``) and impact index on the card; B = 8 and 32 of its pool
    queries, padded to the pool's longest, and a flush of 16 requests padded
    to 32 rows, at rho = 1M and k = 10, with and without a tombstone bitmap.
    Each is :func:`segments_phase` (bit for bit against its plain version
    and the ``[B, P]`` entry, timed beside the gathered route's kernels),
    ``saat_search``'s fused top-k bit for bit against the gathered route's,
    both routes timed from the plan on, and each route's peak memory above
    the index; then :func:`segments_sweep` at B = 32 and at the flush."""
    from portbench.data import make_deployment  # the benchmark's generator, as the cell runs it

    cfg = json.loads(SAAT_CELL_CONFIG.read_text())
    t0 = time.perf_counter()
    dep = make_deployment(cfg, seed, device)
    enc = dep.enc
    index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, dep.n_docs, enc.n_terms,
                               quant=QuantConfig(bits=int(cfg["index"]["bits"])),
                               block_size=int(cfg["index"]["block_size"]), device=device)
    print(f"saat cell: {index.n_docs:,} docs, {index.n_postings:,} postings, index "
          f"{index.nbytes() / 2**30:.4f} GiB, built in {time.perf_counter() - t0:.1f} s")
    qt_np, qw_np = dep.padded_pool()
    rng = np.random.default_rng(seed)
    pick = rng.permutation(qt_np.shape[0])[:32]
    live = torch.as_tensor(rng.random(index.doc_terms.shape[0]) < 0.9, dtype=torch.int32,
                           device=device)
    flush_w = qw_np[pick].copy()
    flush_w[16:] = 0.0  # 16 requests padded to 32 rows
    ms = max_segments_per_term(index)
    n_docs_pad = common.round_up(max(index.doc_terms.shape[0], 512), 512)
    k_out = min(SAAT_CELL_K, index.n_docs)
    for what, bt, bw in (("B=8", qt_np[pick[:8]], qw_np[pick[:8]]),
                         ("B=32", qt_np[pick], qw_np[pick]), ("flush 16 of 32", qt_np[pick], flush_w)):
        bt, bw = torch.as_tensor(bt, device=device), torch.as_tensor(bw, device=device)
        plan = saat_plan(index, bt, bw, ms)
        for lv in (None, live):
            tag = f"cell {what}{' live' if lv is not None else ''}"
            live_pad = None if lv is None else \
                common.pad_axis(lv, 0, n_docs_pad)[:n_docs_pad].contiguous()

            def fused(bt=bt, bw=bw, lv=lv):
                return saat_search(index, bt, bw, k=SAAT_CELL_K, rho=SAAT_CELL_RHO,
                                   max_segs_per_term=ms, fused_topk=True, live_mask=lv)

            def gathered(bt=bt, bw=bw, live_pad=live_pad):
                d, c, _ = _gather_postings_batched(index, saat_plan(index, bt, bw, ms),
                                                   SAAT_CELL_RHO)
                d, c = common.sorted_posting_tiles(d, c, n_docs_pad, 512)
                pool = fused_ops.impact_scatter_topk_launch(d, c, n_docs_pad, index.n_docs,
                                                            min(k_out, 512), 512, live_pad)
                return fused_ops._merge_pool(*pool, k_out)

            row = segments_phase(index, plan, SAAT_CELL_RHO, SAAT_CELL_K, lv, True, tag)
            res, (want_s, want_i) = fused(), gathered()
            check(torch.equal(res.scores, want_s) and torch.equal(res.doc_ids, want_i),
                  f"saat_search {tag}: the fused top-k differs from the gathered route's")
            row.update(fused_route_ms=cuda_ms(fused), gathered_route_ms=cuda_ms(gathered),
                       fused_route_peak_gib=peak_above(fused) / 2**30,
                       gathered_route_peak_gib=peak_above(gathered) / 2**30)
            print(f"  impact_scatter_topk_segments {tag}: "
                  + json.dumps({k: v for k, v in row.items() if k != "what"}))
        if what != "B=8":
            segments_sweep(index, plan, f"cell {what}")


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
    check(docs.shape[1] == e["n_postings"], "scatter edge inputs: not the contract's width")
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


def range_edge_rows(R, seed):
    """Rows in B2's input layout (each sorted, the sentinel ``n_docs`` on
    the tail) at ranges of ``R`` slots, ``P = 6R + 37`` slots a row (no
    multiple of a range): a run across every range boundary; runs longer
    than a range and than its read-past; an empty row; postings only on the
    first doc; on the last; a sparse row whose doc spans hold thousands of
    docs; a row whose real postings end on a range boundary. Returns
    ``(docs i32[7, P], contribs f32[7, P], n_docs)``."""
    rng = np.random.default_rng(seed)
    n_docs, P = 40 * 2048, 6 * R + 37

    def short_runs(n_slots, start, max_gap=5):
        runs, d, at = [], start, 0
        while at < n_slots:
            d += int(rng.integers(1, max_gap + 1))
            n = min(int(rng.integers(1, 5)), n_slots - at)
            runs.append((d, n))
            at += n
        return runs, d

    crossing, d, at = [], -1, 0
    for k in range(1, 6):
        runs, d = short_runs(k * R - 3 - at, d)
        crossing += runs
        d += 1
        crossing.append((d, 6))  # slots kR - 3 .. kR + 2
        at = k * R + 3
    rows = [
        crossing,
        [(3, R // 2), (7, R + scatter_ops.EXTRA + 40), (8, 1), (9, 2 * R + 5)],
        [],
        [(0, 5)],
        [(0, 2), (n_docs - 1, R + 1)],
        [(int(d), 1) for d in np.unique(rng.integers(0, n_docs, 40))],
        short_runs(R, -1)[0],
    ]
    docs = np.full((len(rows), P), n_docs, np.int32)
    c = np.zeros((len(rows), P), np.float32)
    for b, runs in enumerate(rows):
        at = 0
        for d, n in runs:
            docs[b, at:at + n] = d
            c[b, at:at + n] = rng.gamma(2.0, 1.0, n)
            at += n
    check(docs[0, R - 1] == docs[0, R] < n_docs and docs[6, R - 1] < n_docs <= docs[6, R],
          "range edge rows: a boundary run or the row that ends on a boundary is missing")
    return docs, c, n_docs


RANGE_EDGE_STAGES = (1, 2, 4, 8)  # ranges a CTA at the edges: a row of 7 ranges, cut every way


def scatter_range_edges(device, seed) -> None:
    """B2 bit for bit against its plain version at its range edges
    (``range_edge_rows``), at every slots-a-thread the kernel takes and at
    1, 2, 4 and 8 ranges a CTA."""
    chosen = scatter_ops.range_layout
    try:
        for spt in scatter_ops.SLOTS_PER_THREAD:
            docs, c, n_docs = range_edge_rows(scatter_ops.THREADS * spt, seed + spt)
            want = scatter_ref.impact_scatter_batched_ref(torch.as_tensor(docs),
                                                          torch.as_tensor(c), n_docs)
            args = (torch.as_tensor(docs, device=device), torch.as_tensor(c, device=device))
            for stages in RANGE_EDGE_STAGES:
                scatter_ops.range_layout = lambda *a, lay=(spt, stages): lay
                got = scatter_ops.impact_scatter_launch(*args, n_docs, 512)
                sync()
                check(torch.equal(got.cpu(), want),
                      f"impact_scatter range edges spt={spt} stages={stages}: sums differ")
    finally:
        scatter_ops.range_layout = chosen
    print(f"impact_scatter range edges: a run across every range boundary, runs past a range "
          f"and its read-past, an empty row, only the first or last doc, spans of thousands "
          f"of docs, real postings ending on a boundary: equal bit for bit at slots a thread "
          f"{list(scatter_ops.SLOTS_PER_THREAD)} and ranges a CTA {list(RANGE_EDGE_STAGES)}")


def range_sweep(docs, c, n_docs_pad, what) -> None:
    """B2 at each (slots a range, ranges a CTA), replayed from a CUDA graph;
    each output equal to the wrapper's own choice's."""
    chosen = scatter_ops.range_layout
    want = scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, 512)
    times = {}
    try:
        for spt in scatter_ops.SLOTS_PER_THREAD:
            for stages in scatter_ops.STAGES:
                scatter_ops.range_layout = lambda *a, lay=(spt, stages): lay
                got = scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, 512)
                check(torch.equal(got, want),
                      f"impact_scatter {what} spt={spt} stages={stages}: output differs")
                times[f"{scatter_ops.THREADS * spt}x{stages}"] = graph_ms(
                    lambda: scatter_ops.impact_scatter_launch(docs, c, n_docs_pad, 512), 20)
    finally:
        scatter_ops.range_layout = chosen
    spt, stages = chosen(docs.shape[0], docs.shape[1], n_docs_pad,
                         common.sm_count(docs.get_device()))
    best = min(times, key=times.get)
    print(f"  impact_scatter range sweep {what}: ms (CUDA graph) by slots a range x ranges a "
          f"CTA {json.dumps(times)}; the wrapper takes {scatter_ops.THREADS * spt}x{stages}, "
          f"the fastest {best}")


def select_sweep(docs, c, n_docs_pad, n_live, block_d) -> None:
    """The fused kernel's block top-k by the select and by the sort at each
    k_blk, replayed from a CUDA graph; both equal."""
    rule = fused_ops.use_select
    try:
        for k in SELECT_SWEEP_KS:
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
    """The fused scatter kernel at k = 10 at each CTA shape: docs a thread
    and postings staged a doc, replayed from a CUDA graph; every shape's
    output equal to the wrapper's own choice's."""
    chosen = common.scatter_shape
    want = fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, 10, block_d)
    times = {}
    try:
        for dpt in (1, 2, 4):
            for per_doc in (1, 2, 4):
                stage = per_doc * block_d
                common.scatter_shape = lambda bd, dpt=dpt, stage=stage: dict(
                    dpt=dpt, threads=bd // dpt, stage=stage, smem=8 * stage + 4 * bd)
                got = fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, 10, block_d)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"impact_scatter_topk at {dpt} docs a thread, stage {stage}: output differs")
                times[f"dpt{dpt} stage{stage}"] = graph_ms(
                    lambda: fused_ops.impact_scatter_topk_launch(docs, c, n_docs_pad, n_live, 10,
                                                                 block_d), 20)
    finally:
        common.scatter_shape = chosen
    print(f"  impact_scatter_topk shape sweep B={docs.shape[0]} block_d={block_d} k=10: ms "
          f"(CUDA graph) by shape {json.dumps(times)}; the wrapper takes "
          f"{json.dumps(chosen(block_d))}")


def main_shape_phases(index, qt, qw, live) -> dict:
    """Both kernels at the main path's shapes: one batch at rho = 1M."""
    ms = max_segments_per_term(index)
    n_docs_pad = index.doc_terms.shape[0]
    plan = saat_plan(index, qt, qw, ms)
    rows = {"impact_scatter": [], "impact_scatter_topk": []}
    # B2 at rho = 1M and 100k, B = 64 and 1 (the kernels line reports the
    # first row of each of B = 64 and 1); B = 63 untimed; its range swept at
    # B = 64 and 1M only, for the run's time budget
    for rho in SCATTER_RHOS:
        d, v, _ = _gather_postings_batched(index, plan, rho)
        tag = f"rho={rho // 1000}k" if rho < 1_000_000 else "rho=1M"
        B = d.shape[0]
        rows["impact_scatter"].append(scatter_phase(
            d, v, n_docs_pad, 512, 512, single=False, timed=True, what=f"main B={B} {tag}"))
        rows["impact_scatter"].append(scatter_phase(
            d[:1], v[:1], n_docs_pad, 512, 512, single=True, timed=True, what=f"main B=1 {tag}"))
        scatter_phase(d[:63], v[:63], n_docs_pad, 512, 512, single=False, timed=False,
                      what=f"main B=63 {tag}")
        if rho == 1_000_000:
            pad = common.round_up(index.n_docs, 512)
            sd, sc = common.sorted_posting_tiles(d, v, pad, 512)
            range_sweep(sd, sc, pad, f"B={B} {tag}")
            del sd, sc
        del d, v
    docs, contribs, _ = _gather_postings_batched(index, plan, 1_000_000)
    B = docs.shape[0]
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
    del docs, contribs, sd, sc
    rows["impact_scatter_topk_segments"] = [
        segments_phase(index, plan, rho, k, lv, timed, f"{tag} B={B} k={k}{' live' if lv is not None else ''}")
        for tag, rho, k, lv, timed in (("main rho=1M", 1_000_000, 10, None, True),
                                       ("edge rho=1M", 1_000_000, 1000, live, False),
                                       ("edge exact", index.n_postings, 10, None, False))]
    segments_sweep(index, plan, f"main B={B} rho=1M")
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
    data, encs = {}, {}
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
        encs[m] = enc
    return corpus, data, encs


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


def profile_call(label, fn) -> None:
    """``fn()`` once under ``torch.profiler`` (after one call outside it):
    device time by kernel and by the PyTorch operator that launched it, and
    the device's busy share of the call's (profiled) wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # self device time and count by (device type, name), as key_averages()
    # groups them, summed directly: key_averages() keeps every statistic of
    # every event and took seconds of host time a step on a model's profile
    sums: dict = {}
    for e in prof.events():
        acc = sums.setdefault((e.device_type, e.key), [0.0, 0])
        acc[0] += e.self_device_time_total
        acc[1] += 1
    kernels = sorted(((t, n, key) for (dt, key), (t, n) in sums.items() if dt == DeviceType.CUDA),
                     key=lambda r: r[0], reverse=True)
    ops = sorted(((t, n, key) for (dt, key), (t, n) in sums.items()
                  if dt == DeviceType.CPU and t > 0), key=lambda r: r[0], reverse=True)
    busy_us = sum(t for t, _, _ in kernels)
    print(f"profile {label}: profiled wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    for what, rows in (("operator", ops), ("kernel", kernels)):
        for t, n, key in rows[:8]:
            print(f"  {what} {t / 1e3:8.3f} ms x{n:<4d} {key[:80]}")


def profile_batch(index, bt, bw, k, rho) -> None:
    """One fused SAAT batch under ``torch.profiler``."""
    ms = max_segments_per_term(index)
    profile_call(f"spladev2 k={k} rho={rho} fused B={bt.shape[0]}",
                 lambda: saat_search(index, bt, bw, k=k, rho=rho, max_segs_per_term=ms,
                                     fused_topk=True))


# ---------------------------------------------------------------------------
# DAAT kernel phases: block_prune_csr (B3), block_topk (B6), sparse_score
# (B7), chunk_step (B4) and chunk_step_multi (B5) against their plain
# versions, run on a host copy of the inputs; at the main shapes B4's and
# B5's plain trips run on the card (on the host each trip scores the whole
# budget's rows in about 3 s, and the edges take dozens of trips). Their
# scores are held within RTOL and their ids but at near-ties, so the sum's
# order does not matter there.
# ---------------------------------------------------------------------------


def prune_inputs(dims: dict, seed: int, device):
    """CSR block-max lists of random terms and per-(query, slot) windows into
    them, a fifth of them (or ``dims["empty"]``) empty pad slots; one row
    with theta = -inf. ``edge_tile``: the first lists hold the blocks on both
    sides of every multiple of it, and every query reads them. ``cut``: the
    lists end at the end of the arrays, and each query's last window runs 7
    entries past them."""
    rng = np.random.default_rng(seed)
    nb, m, n_bm = dims["nb"], dims["m"], dims["n_bm"]
    starts, counts, total = [], [], 0
    bm_block = np.zeros(n_bm, np.int32)
    if dims.get("edge_tile"):
        edges = [t for t0 in range(dims["edge_tile"], nb, dims["edge_tile"]) for t in (t0 - 1, t0)]
        for lst in (edges, edges[::2], edges[1::2], [0, nb - 1]):
            bm_block[total:total + len(lst)] = lst
            starts.append(total)
            counts.append(len(lst))
            total += len(lst)
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
    if dims.get("edge_tile"):
        terms[:, :4] = np.arange(4)
    base = np.asarray(starts, np.int32)[terms]
    cnt = np.minimum(np.asarray(counts, np.int32)[terms], m)
    if dims.get("cut"):
        bm_block, bm_weight = bm_block[:total], bm_weight[:total]
        base[:, -1], cnt[:, -1] = starts[-1], counts[-1] + 7
    qw = rng.gamma(1.0, 1.0, terms.shape).astype(np.float32)
    empty = rng.random(terms.shape) < dims.get("empty", 0.2)
    base[empty], cnt[empty], qw[empty] = total, 0, 0.0
    theta = rng.uniform(0.0, 2.0, dims["batch"]).astype(np.float32)
    theta[0] = -np.inf
    return tuple(torch.as_tensor(a, device=device)
                 for a in (bm_block, bm_weight, base, cnt, qw, theta))


def prune_plain(args, n_blocks):
    """The plain block_prune_csr on a host copy of the inputs."""
    m = max(1, int(args[3].max())) if args[3].numel() else 1
    return prune_ref.block_prune_csr_batched_ref(*(a.cpu() for a in args), n_blocks=n_blocks,
                                                 max_bm_per_term=m)


def prune_check(args, n_blocks, want, what, tiles=(prune_ops.PRUNE_TILE,)) -> None:
    """block_prune_csr at each tile: ub equal bit for bit, the mask equal."""
    for tile in tiles:
        gu, gm = prune_ops.block_prune_csr_launch(*args, n_blocks, tile)
        sync()
        check(torch.equal(gu.cpu(), want[0]),
              f"block_prune_csr {what} tile={tile}: ub differs from the plain version")
        check(torch.equal(gm.cpu(), want[1]), f"block_prune_csr {what} tile={tile}: mask differs")


def prune_phase(args, n_blocks, timed, what) -> dict:
    """block_prune_csr: ub equal bit for bit and the mask equal."""
    bm_block, bm_weight, base, cnt, qw, theta = args
    m = max(1, int(cnt.max()))
    prune_check(args, n_blocks, prune_plain(args, n_blocks), what)
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


def prune_edge_phases(device, seed) -> None:
    """block_prune_csr bit for bit at its edges (PRUNE_EDGE_CASES), at every
    tile of the sweep and the wrapper's."""
    tiles = tuple(sorted(set(PRUNE_SWEEP_TILES) | {prune_ops.PRUNE_TILE}))
    for i, (name, dims) in enumerate(PRUNE_EDGE_CASES):
        args = prune_inputs(dims, seed + 250 + i, device)
        prune_check(args, dims["nb"], prune_plain(args, dims["nb"]), f"edge {name}", tiles)
    print(f"block_prune_csr edge phases: {len(PRUNE_EDGE_CASES)} cases at tiles {list(tiles)}, "
          f"each equal bit for bit to the plain version")


def prune_tile_sweep(args, n_blocks, what) -> None:
    """Graph ms of block_prune_csr by blocks a CTA, each tile held bit for
    bit against the plain version first."""
    want = prune_plain(args, n_blocks)
    out = {}
    for tile in PRUNE_SWEEP_TILES:
        prune_check(args, n_blocks, want, f"sweep {what}", (tile,))
        out[tile] = graph_ms(lambda: prune_ops.block_prune_csr_launch(*args, n_blocks, tile))
    print(f"  block_prune_csr tile sweep {what}: ms (CUDA graph) by blocks a CTA "
          f"{json.dumps(out)}; the wrapper takes {prune_ops.PRUNE_TILE}")


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
    B = ub.shape[0]
    if trips is None:
        got = chunk_ops.chunk_step_batched(*args, live=live, **kw)
        want = chunk_ref.chunk_step_batched_ref(*args, live=live, **kw)
        one_trip = torch.ones(B, dtype=torch.int32, device=ub.device)
        got, want = got + (one_trip,), want + (one_trip,)
        trips_left = None
    else:
        # as the engine: every row that can still move gets the whole budget
        active = torch.where(processed, float("-inf"), ub).amax(dim=-1) > theta
        budgets = 1 + torch.arange(B, device=ub.device) % trips if vary_trips else trips
        trips_left = torch.where(active, budgets, 0).to(torch.int32)
        got = chunk_ops.chunk_step_multi_batched(*args, trips_left, trips_per_launch=trips,
                                                 live=live, **kw)
        want = chunk_ref.chunk_step_multi_batched_ref(*args, trips_left, trips_per_launch=trips,
                                                      live=live, **kw)
    sync()
    got, want = tuple(t.cpu() for t in got), tuple(t.cpu() for t in want)
    gs, gi, gth, gpr, gtd = got
    ws, wi, wth, wpr, wtd = want
    ok = ((gpr == wpr).all(dim=-1) & (gtd == wtd) & close_rows(gs, ws)
          & close_rows(gth[:, None], wth[:, None]))
    bad = ~ok
    if bool(bad.any()):
        # the plain trip sequence's thetas, one trip at a time
        thetas, st = [theta, wth, gth], args[4:]
        for t in range(1 if trips is None else trips):
            ns, ni, nth, npr = chunk_ref.chunk_step_batched_ref(*args[:4], *st, live=live, **kw)
            thetas.append(nth)
            st = (st[0], npr, ns, ni, nth)
        tied = near_tie_rows(ub, thetas)
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
        new = wpr.to(ub.device) & ~processed
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
    prune_edge_phases(device, seed)
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
    prune_args = (index.bm_block, index.bm_weight, base, cnt, qw.float().contiguous(), theta)
    rows["block_prune_csr"].append(prune_phase(prune_args, index.n_blocks, True, f"main B={B}"))
    for b, timed in ((1, True), (B - 1, False)):
        rows["block_prune_csr"].append(prune_phase(
            prune_args[:2] + tuple(a[:b].contiguous() for a in prune_args[2:]), index.n_blocks,
            timed, f"main B={b}"))
    prune_tile_sweep(prune_args, index.n_blocks, f"B={B}")
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
# the weight analysis (core/wacky.py, core/pareto.py)
# ---------------------------------------------------------------------------


def wacky_phase(data, raw_weights, k) -> dict:
    """``full_report`` per treatment over every query, one line each, with
    the launch counters set to 0 just before and read just after; each
    number finite and each share in [0, 1]; then the bounds
    ``skip_opportunity`` takes (one block_prune_csr launch a treatment) held
    bit for bit against the plain ``block_upper_bounds``. Returns the
    launches."""
    sync()
    reset_launches()
    reports = {m: wacky.full_report(m, index, raw_weights[m], qt, qw, k=k)
               for m, (index, qt, qw) in data.items()}
    sync()
    launches = read_launches()
    check(launches["block_prune_csr"] == len(data),
          f"the weight analysis launched block_prune_csr {launches['block_prune_csr']} times, "
          f"not once a treatment")
    for m, rep in reports.items():
        print(f"wacky report {m} k={k} over {data[m][1].shape[0]} queries: {json.dumps(rep)}")
        nums = [v for part in rep.values() if isinstance(part, dict) for v in part.values()]
        check(all(np.isfinite(v) for v in nums), f"wacky {m}: a number is not finite")
        check(all(0.0 <= v <= 1.0 for key, v in rep["skip"].items() if "fraction" in key)
              and rep["skip"]["candidate_blocks_mean"] <= data[m][0].n_blocks,
              f"wacky {m}: a skippable share or the candidate count is out of range")
    for m, (index, qt, qw) in data.items():
        mb = max_blocks_per_term(index)
        check(torch.equal(wacky.batch_upper_bounds(index, qt, qw, mb),
                          block_upper_bounds(index, qt, qw, mb)),
              f"wacky {m}: skip_opportunity's bounds differ from block_upper_bounds")
    print(f"wacky: skip_opportunity's bounds equal block_upper_bounds bit for bit; launches "
          f"{ {n: v for n, v in launches.items() if v} }")
    return launches


def frontier_phase(data, qrels, rr, latency, d_results, d_latency) -> None:
    """Operating points from this run's k = 10 batches: SAAT (fused kernel)
    at each rho, DAAT in each mode, exact and one trip; RR@10 over every
    query, latency the median batch over its B queries (host clock). Prints
    ``frontier_table``."""
    points = []
    for (m, k, rho, route), v in latency.items():
        if k == 10 and route == "fused":
            points.append(OperatingPoint(f"{m}/saat-rho={rho}", m, "saat",
                                         rr[f"{m} k={k} rho={rho}"], float(np.median(v)) / BATCH))
    for (m, k, exact, mode), v in d_latency.items():
        if k != 10:
            continue
        ids = [d_results[(m, k, exact, mode, lo)].doc_ids.cpu().numpy()
               for lo in range(0, data[m][1].shape[0], BATCH)]
        points.append(OperatingPoint(f"{m}/daat-{mode}{'' if exact else '-1trip'}", m, "daat",
                                     mrr_at_k(np.concatenate(ids), qrels, 10),
                                     float(np.median(v)) / BATCH))
    table = frontier_table(points)
    check(len(table) == len(points) and any(r["pareto"] for r in table),
          "the frontier table is empty or has no point on the frontier")
    print(f"frontier ({len(points)} operating points, k = 10, RR@10 and ms a query, host clock, "
          f"B={BATCH}):")
    for row in table:
        print(f"  {json.dumps(row)}")


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
    kw = dict(k=k, exact=True, max_bm_per_term=max_blocks_per_term(index), use_kernels=True,
              fused_chunk=True, **DAAT_KW)
    trips = int(daat_search_batched(index, bt, bw, **kw).chunks.max())
    profile_call(f"DAAT spladev2 k={k} exact fused B={bt.shape[0]} ({trips} trips)",
                 lambda: daat_search_batched(index, bt, bw, **kw))


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
    for i, (name, dims) in enumerate(DENSE_PRUNE_CASES + DENSE_PRUNE_EDGE_CASES):
        args = dense_prune_inputs(dims, seed + 650 + i, device)
        want = dense_prune_ref.block_prune_batched_ref(*(a.cpu() for a in args))
        for tile in dense_prune_ops.TILES:
            dense_prune_check(dense_prune_ops.block_prune_launch(*args, tile=tile), want,
                              f"block_prune {name} tile={tile}")
    sync()
    print(f"dense prune contract phase: {len(DENSE_PRUNE_CASES)} shapes equal to the plain "
          f"version bit for bit; with {len(DENSE_PRUNE_EDGE_CASES)} edge cases, at every tile "
          f"{list(dense_prune_ops.TILES)}")

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
        kernel = lambda: dense_prune_ops.block_prune_launch(bm, w, th)  # noqa: E731
        library = lambda: torch.bmm(w[:, None], bm)  # noqa: E731
        rows[name] = [{
            "what": f"main B={b}", "max_abs_err": 0.0,
            **timings(kernel, lambda: dense_prune_ref.block_prune_batched_ref(bm, w, th), library),
            "cold_ms": cold_ms(dense_prune_ops.block_prune_launch, (bm, w, th)),
            "library_cold_ms": cold_ms(lambda x, y: torch.bmm(y[:, None], x), (bm, w)),
            # each block maximum, weight and theta read once; ub (f32) and
            # the mask (bool) written once
            "bound_ms": 1e3 * (4 * b * lq * nb + 4 * b * lq + 4 * b + 5 * b * nb)
            / HBM_BYTES_PER_S,
            "shape": [b, lq, nb],
            "tile": dense_prune_ops.PRUNE_TILE,
        }]
        if b == 1:
            rows[name][0].update(host_us=host_us(kernel), library_host_us=host_us(library))
        print(f"  {name} {rows[name][0]['what']}: "
              + json.dumps({k: v for k, v in rows[name][0].items() if k != "what"}))
        times = {}
        for tile in dense_prune_ops.TILES:
            dense_prune_check(dense_prune_ops.block_prune_launch(bm, w, th, tile=tile),
                              (ub[:b], mask[:b]), f"block_prune sweep B={b} tile={tile}")
            times[tile] = graph_ms(lambda: dense_prune_ops.block_prune_launch(bm, w, th, tile=tile))
        print(f"  block_prune tile sweep B={b}: ms (CUDA graph) by blocks a CTA "
              f"{json.dumps(times)}; the wrapper takes {rows[name][0]['tile']}")
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
    check(launches["impact_scatter_topk_segments"] > 0 and launches["impact_scatter_topk"] == 0,
          f"direct serving did not launch the segment entry alone: {launches}")
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
    check(launches["impact_scatter_topk_segments"] > 0 and launches["impact_scatter_topk"] == 0,
          f"queue serving did not launch the segment entry alone: {launches}")
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
    for name in ("impact_scatter_topk_segments", "block_prune_csr", "block_topk", "sparse_score",
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


def shard_stack(enc, n_docs, device, card):
    """The spladev2 corpus re-sharded ``SHARDS`` ways with ``shard_corpus``
    (each shard built on the host, placed on the card) and stacked there."""
    t0 = time.perf_counter()
    shards, dps = shard_corpus(enc.doc_idx, enc.term_idx, enc.weights, n_docs, enc.n_terms,
                               SHARDS, device=device)
    build_s = time.perf_counter() - t0
    stack = stack_indexes(shards)
    del shards
    sync()
    print(f"sharded: {SHARDS} shards of {dps} docs ({n_docs - (SHARDS - 1) * dps} in the last), "
          f"{stack.n_blocks} blocks of {stack.block_size} a shard, {stack.doc_ids.shape[1]} "
          f"postings a shard (padded), Tmax {stack.max_doc_terms}; built in {build_s:.1f} s "
          f"(host), stacked {stack.nbytes() / 1e9:.3f} GB on {device} in "
          f"{time.perf_counter() - t0 - build_s:.1f} s; card {card}")
    return stack, dps


def shard_views(stack, dps):
    """Each shard of the stack as the serve step searches it (views of its
    rows, with the stack's build constants)."""
    data = _index_data_dict(stack)
    meta = dict(block_size=stack.block_size, scale=stack.scale, bits=stack.bits,
                max_segs=stack.max_segs, max_bm=stack.max_bm)
    return [_local_index(data, j, dps, meta) for j in range(stack.doc_ids.shape[0])]


def sharded_routes(stack, dps, n_docs):
    """The pod and sharded steps' keywords per route, at exact budgets."""
    base = dict(k=SERVE_K, max_segs_per_term=stack.max_segs, docs_per_shard=dps,
                n_docs_total=n_docs)
    exact = int(stack.doc_ids.shape[1])
    return {
        "SAAT fused": dict(base, rho_per_shard=exact, fused_topk=True),
        "SAAT kernel": dict(base, rho_per_shard=exact, scatter_impl="kernel"),
        "DAAT fused": dict(base, rho_per_shard=0, engine="daat",
                           daat_est_blocks=DAAT_KW["est_blocks"],
                           daat_block_budget=DAAT_KW["block_budget"],
                           max_bm_per_term=stack.max_bm, daat_use_kernels=True,
                           daat_fused_chunk=True),
    }


def nccl_world_of_one(stack, bt, bw, kw, want, device) -> str:
    """The (1, 1) sharded step over an NCCL process group of one rank
    (rendezvous through a FileStore under build/): equal bit for bit to the
    in-process step. Returns the backend's name."""
    store = Path(__file__).resolve().parent / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        serve, in_specs, _ = make_sharded_serve_step(mesh, group=dist.group.WORLD, **kw)
        s, i = serve(*(rank_block(x, spec, mesh, 0) for x, spec in zip((stack, bt, bw), in_specs)))
        sync()
        check(torch.equal(s, want[0]) and torch.equal(i, want[1]),
              "sharded: the NCCL world-of-one step differs from the in-process (1, 1) step")
        return dist.get_backend()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def pod_front_end(stack, dps, n_docs, qt_np, qw_np, seed, card) -> None:
    """``PodFrontEnd`` at 2 hosts over the 4-shard stack at the queue
    phase's settings: Poisson arrivals split between the hosts, each host's
    queue flushing into the pod step; every request completes once, and
    each completion equals the pod step called directly on its flush's
    batch (the other host's rows sentinels) at the flush's rho."""
    device = stack.device
    n_terms = stack.n_terms
    buckets = (8, 16, max(16, qt_np.shape[1]))
    clock = HybridClock()
    cfg = ServingConfig(k=SERVE_K, rho_ladder=SERVE_LADDER, batch_size=QUEUE_SHAPES[-1],
                        fused_topk=True, lq_buckets=buckets)
    front = PodFrontEnd(make_mesh(POD_LAYOUT, ("pod", "model"), device=device), stack, cfg,
                        docs_per_shard=dps, n_docs_total=n_docs, clock=clock,
                        queue_kwargs=dict(batch_shapes=QUEUE_SHAPES, clock=clock,
                                          safety_ms=QUEUE_SAFETY_MS, degrade_rho=True))
    t0 = time.perf_counter()
    warmup_pod(front, qt_np[:8], qw_np[:8], batch_sizes=QUEUE_SHAPES)
    warm_s = time.perf_counter() - t0
    for srv in front.servers:
        srv.reset_stats()
    rng = np.random.default_rng(seed + 2)
    arrivals = clock.now() + np.cumsum(rng.exponential(1.0 / QUEUE_QPS, size=POD_REQUESTS))
    order = rng.integers(0, qt_np.shape[0], size=POD_REQUESTS)
    requests = [[] for _ in range(front.n_hosts)]  # each host's, by rid
    comps, i, inf = [], 0, float("inf")
    t0 = time.perf_counter()
    while i < POD_REQUESTS or front.pending():
        dues = [d for d in (q.next_due() for q in front.queues) if d is not None]
        t_due = min(dues) if dues else inf
        if i < POD_REQUESTS and arrivals[i] <= t_due:
            clock.advance_to(arrivals[i])
            host = i % front.n_hosts
            req = (qt_np[order[i]], qw_np[order[i]])
            check(front.submit(host, *req, QUEUE_DEADLINE_MS) == len(requests[host]),
                  "pod front end: a host's rids are not its arrival order")
            requests[host].append(req)
            i += 1
        else:
            clock.advance_to(t_due)
        comps.extend(front.poll())
    replay_s = time.perf_counter() - t0
    by = {(h, c.rid): c for h, c in comps}
    check(len(comps) == POD_REQUESTS and sorted(by) == sorted(
        (h, r) for h in range(front.n_hosts) for r in range(len(requests[h]))),
        "pod front end: a request was lost or served twice")
    flushes = 0
    for h, (srv, q) in enumerate(zip(front.servers, front.queues)):
        for f in q.flush_log:
            bt, bw = flush_batch(f, requests[h], n_terms)
            B = f.batch_shape
            gqt, gqw = sentinel_rows(front.n_hosts * B, f.bucket, n_terms)
            gqt[h * B:(h + 1) * B], gqw[h * B:(h + 1) * B] = bt, bw
            _, ids = srv.serve_step(f.rho)(stack, gqt, gqw)
            ids = ids[h * B:(h + 1) * B].cpu().numpy()
            for j, rid in enumerate(f.rids):
                check(np.array_equal(by[(h, rid)].doc_ids, ids[j]),
                      f"pod front end: host {h} request {rid} differs from the pod step at rho "
                      f"{f.rho}")
            flushes += 1
    counters = front.export_counters().as_dict()
    dispatch = {",".join(f"{k}={v}" for k, v in sorted(smp["labels"].items())): smp["value"]
                for smp in counters["repro_pod_dispatch_total"]["samples"]}
    fanin = sorted({smp["value"] for smp in counters["repro_pod_merge_fanin"]["samples"]})
    waits = summarize_latencies([c.wait_ms for _, c in comps])
    served = {}
    for _, c in comps:
        served[str(c.rho)] = served.get(str(c.rho), 0) + 1
    print(f"pod front end: {POD_REQUESTS} requests at {QUEUE_QPS:.0f} qps split over "
          f"{front.n_hosts} hosts, deadline {QUEUE_DEADLINE_MS} ms, buckets {buckets}, shapes "
          f"{QUEUE_SHAPES}; warm-up {warm_s:.1f} s, replay {replay_s:.2f} s; {flushes} flushes, "
          f"violations {sum(q.n_violations for q in front.queues)}, degraded "
          f"{sum(q.n_degraded for q in front.queues)}; served rho (requests) {served}; wait "
          f"{latency_line(waits)}; every completion equals the pod step at its rho; dispatches "
          f"{json.dumps(dispatch)}; merge_fanin {fanin}; card {card}")


def sharded_timings(stack, dps, n_docs, qt, qw, qrels, rr_1m, card) -> None:
    """Printed, not checked: the pod step's batch latency per route (median
    and max of 4 after one warm-up, host clock); each shard's engine time
    (CUDA events, median of 3 after one warm-up) for SAAT fused at 250k and
    at exact, and DAAT fused exact with its trips; RR@10 of the pod step at
    4 x 250k against the unsharded 1M; the merge's time."""
    bt, bw = qt[:BATCH], qw[:BATCH]
    pod = make_mesh(POD_LAYOUT, ("pod", "model"), device=stack.device)
    for name, kw in sharded_routes(stack, dps, n_docs).items():
        serve, _, _ = make_pod_serve_step(pod, **kw)
        serve(stack, bt, bw)
        times = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            serve(stack, bt, bw)
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"pod step {POD_LAYOUT} {name} k={SERVE_K} exact B={BATCH}: median "
              f"{np.median(times):.3f} ms, max {max(times):.3f} ms over 4 (host clock); "
              f"card {card}")

    def per_shard(fn):
        out = []
        for view in shard_views(stack, dps):
            fn(view)
            ms = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = fn(view)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            out.append((float(np.median(ms)), res))
        return out

    pools = None
    for label, rho in (("250k", SHARD_RHO), ("exact", int(stack.doc_ids.shape[1]))):
        rows = per_shard(lambda v, r=rho: saat_search(v, bt, bw, k=SERVE_K, rho=r,
                                                      max_segs_per_term=stack.max_segs,
                                                      fused_topk=True))
        ms = [r[0] for r in rows]
        print(f"per-shard SAAT fused rho={label} B={BATCH}: ms {[round(m, 3) for m in ms]}, "
              f"max/min {max(ms) / min(ms):.3f}; postings "
              f"{[int(r[1].postings_processed.sum()) for r in rows]}; card {card}")
        pools = [(r[1].scores, (r[1].doc_ids + j * dps).to(torch.int32))
                 for j, r in enumerate(rows)]
    rows = per_shard(lambda v: daat_search_batched(v, bt, bw, k=SERVE_K,
                                                   max_bm_per_term=stack.max_bm, use_kernels=True,
                                                   fused_chunk=True, **DAAT_KW))
    ms = [r[0] for r in rows]
    print(f"per-shard DAAT fused exact B={BATCH}: ms {[round(m, 3) for m in ms]}, max/min "
          f"{max(ms) / min(ms):.3f}; trips {[int(r[1].chunks.max()) for r in rows]}; "
          f"card {card}")
    ps, pi = [p[0] for p in pools], [p[1] for p in pools]
    merge_ms = cuda_ms(lambda: canonical_topk_merge(ps, pi, SERVE_K), iters=20)
    print(f"canonical_topk_merge of {SHARDS} pools [{BATCH}, {SERVE_K}]: {merge_ms:.4f} ms "
          f"(CUDA events, back to back); card {card}")
    serve, _, _ = make_pod_serve_step(pod, **dict(sharded_routes(stack, dps, n_docs)["SAAT fused"],
                                                  rho_per_shard=SHARD_RHO))
    ids = [serve(stack, qt[lo:lo + BATCH], qw[lo:lo + BATCH])[1].cpu().numpy()
           for lo in range(0, qt.shape[0], BATCH)]
    rr = mrr_at_k(np.concatenate(ids), qrels, 10)
    print(f"RR@10 at {SHARDS} x {SHARD_RHO} (pod step, SAAT fused): {rr:.4f}; unsharded "
          f"rho=1M: {rr_1m:.4f}; card {card}")


def sharded_phase(enc, index, qt, qw, live, results, d_results, qrels, rr_1m, seed, card) -> None:
    """Doc-sharded serving over the spladev2 shard re-sharded 4 ways:

    1. the in-process pod step at (pod=2, model=2) on the card, B = 64,
       k = 10, exact: SAAT through B1 (fused) and B2 (kernel scatter), and
       DAAT fused, each against the unsharded engine's exact batch (ids
       equal but at checked near-ties, scores within RTOL);
    2. the sharded step at (1, 1), all 4 shards on one rank: equal bit for
       bit to check 1;
    3. the (1, 1) step over an NCCL process group of one rank: equal bit
       for bit to the in-process step;
    4. the run's 0.9 tombstone bitmap through ``shard_live_stack``: the
       live-masked pod step against the unsharded live-masked SAAT batch;
    5. ``PodFrontEnd`` at 2 hosts (``pod_front_end``).

    The launch counters are set to 0 before check 1 and read after check
    5; every kernel of the path must have launched. Then the timings."""
    device = index.device
    n_docs = index.n_docs
    stack, dps = shard_stack(enc, n_docs, device, card)
    bt, bw = qt[:BATCH], qw[:BATCH]
    routes = sharded_routes(stack, dps, n_docs)
    want = {
        "SAAT fused": results[(MAIN_SHAPE[0], SERVE_K, "exact", "fused", 0)][0],
        "SAAT kernel": results[(MAIN_SHAPE[0], SERVE_K, "exact", "kernel", 0)][0],
        "DAAT fused": d_results[(MAIN_SHAPE[0], SERVE_K, True, "fused", 0)],
    }
    pod = make_mesh(POD_LAYOUT, ("pod", "model"), device=device)
    one = make_mesh((1, 1), ("data", "model"), device=device)
    reset_launches()
    answers, swaps = {}, {}
    for name, kw in routes.items():
        s, i = make_pod_serve_step(pod, **kw)[0](stack, bt, bw)
        swaps[name] = tie_swaps(s, i, want[name].scores, want[name].doc_ids,
                                f"sharded {name} at {POD_LAYOUT} vs unsharded")
        s1, i1 = make_sharded_serve_step(one, **kw)[0](stack, bt, bw)
        check(torch.equal(s1, s) and torch.equal(i1, i),
              f"sharded {name}: (1, 1) with {SHARDS} shards on one rank differs from {POD_LAYOUT}")
        answers[name] = (s1, i1)
    backend = nccl_world_of_one(stack, bt, bw, routes["SAAT fused"], answers["SAAT fused"], device)
    live_stack = shard_live_stack(live[:n_docs].cpu().numpy(), n_shards=SHARDS,
                                  docs_per_shard=dps, n_docs_pad=int(stack.doc_n_terms.shape[1]))
    s, i = make_pod_serve_step(pod, live_masked=True, **routes["SAAT fused"])[0](
        stack, bt, bw, live_stack=live_stack)
    plain = saat_search(index, bt, bw, k=SERVE_K, rho=index.n_postings,
                        max_segs_per_term=max_segments_per_term(index), fused_topk=True,
                        live_mask=live)
    swaps["SAAT fused live"] = tie_swaps(s, i, plain.scores, plain.doc_ids,
                                         f"sharded live-masked at {POD_LAYOUT} vs unsharded")
    fin = torch.isfinite(s)
    check(bool((live[i.long()[fin]] != 0).all()), "sharded live-masked: a tombstoned doc came back")
    pod_front_end(stack, dps, n_docs, qt.cpu().numpy(), qw.cpu().numpy(), seed, card)
    launches = read_launches()
    path = ("impact_scatter", "impact_scatter_topk_segments", "block_prune_csr", "block_topk",
            "sparse_score", "chunk_step")
    for name in path:
        check(launches[name] > 0, f"sharded serving: kernel {name} was not launched")
    print(f"sharded serving: {POD_LAYOUT} pod step (SAAT fused, SAAT kernel, DAAT fused) equal to "
          f"the unsharded engines but at near-ties (ranks that differ {swaps}); (1, 1) with "
          f"{SHARDS} shards a rank equal bit for bit; the {backend} world-of-one step equal bit "
          f"for bit (torch.cuda.device_count() = {torch.cuda.device_count()}); live-masked equal "
          f"to the unsharded live batch; launches "
          f"{json.dumps({n: launches[n] for n in path})}; card {card}")
    sharded_timings(stack, dps, n_docs, qt, qw, qrels, rr_1m, card)


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


# ---------------------------------------------------------------------------
# the trainable encoder (queue A11): parity with the CPU, training at full
# width, and the example's loop from training to SAAT
# ---------------------------------------------------------------------------

# test_e2e.py's encoder size and corpus, trained on both devices
ENC_PARITY = dict(d_model=64, n_layers=2, steps=5, batch=16, q_len=8, d_len=32,
                  corpus=dict(n_docs=300, n_queries=60, n_concepts=40, seed=1))
# the card against the CPU, both f32 (TF32 off): a few ulps apart a product,
# so the encoding, step 0's loss and its gradients tightly; AdamW moves
# every weight with a nonzero gradient by about lr at first, whatever the
# gradient's size, so the later losses within ENC_LOSS_RTOL
ENC_REP_RTOL, ENC_REP_ATOL = 1e-4, 1e-5
ENC_LOSS0_RTOL = 1e-5
ENC_GRAD_RTOL, ENC_GRAD_ATOL_FRAC = 1e-3, 1e-4  # atol: a share of the leaf's largest gradient
ENC_LOSS_RTOL = 1e-3
# DistilBERT's widths (distilbert-base-uncased, the encoder SPLADEv2 is
# fine-tuned from): 6 layers, d_model 768, 12 heads of 64, d_ff 3072; the
# vocabulary is the corpus's surface terms
ENC_FULL = dict(d_model=768, n_layers=6, batch=32, q_len=16, d_len=64, warmup=2, timed=20,
                encode_docs=2048, encode_batch=64)
ENC_FLOPS_WEIGHT = 3e-4  # the example's
ENC_ADAMW = dict(lr=2e-3, warmup_steps=20, total_steps=300)  # the example's
F32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s


def encoder_cfg(d_model, n_layers, vocab, head="splade"):
    return SparseEncoderConfig(encoder_backbone(d_model=d_model, n_layers=n_layers, vocab=vocab),
                               head=head, flops_weight=ENC_FLOPS_WEIGHT,
                               query_flops_weight=3 * ENC_FLOPS_WEIGHT)


def encoder_parity(device) -> None:
    """Both heads at test_e2e.py's size: the same initial params and the same
    ``TripleSampler`` batches on the card and on the CPU; the encoding, step
    0's loss and gradients, and the loss of each of 5 ``train_loop`` steps."""
    p = ENC_PARITY
    corpus = generate_corpus(CorpusConfig(**p["corpus"]))
    for head in ("splade", "unicoil"):
        cfg = encoder_cfg(p["d_model"], p["n_layers"], corpus.config.n_surface_terms, head)
        cpu = init_encoder_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        card = copy.deepcopy(cpu).to(device)
        init64 = copy.deepcopy(cpu).double()  # train_loop updates ``cpu`` in place
        runs = {}
        for dev, model in (("cpu", cpu), ("card", card)):
            sampler = TripleSampler(corpus, q_len=p["q_len"], d_len=p["d_len"],
                                    device="cpu" if dev == "cpu" else device)
            batches = list(itertools.islice(sampler.batches(p["batch"]), p["steps"]))
            with torch.no_grad():
                rep = encode(model, batches[0]["pos"], batches[0]["pos_mask"], cfg)
            loss, _ = encoder_loss(model, batches[0], cfg)
            grads = torch.autograd.grad(loss, list(model.parameters()))
            step = make_train_step(lambda m, b: encoder_loss(m, b, cfg), AdamWConfig(**ENC_ADAMW))
            _, hist = train_loop(step, init_train_state(model), batches)
            runs[dev] = rep, loss.detach(), grads, [h["loss"] for h in hist]
        (rep_c, loss_c, g_c, l_c), (rep_g, loss_g, g_g, l_g) = runs["cpu"], runs["card"]
        # each side's distance from an f64 run on the host: which one moved
        cfg64 = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone,
                                                                      dtype=torch.float64))
        with torch.no_grad():
            rep64 = encode(init64, batches[0]["pos"].cpu(),
                           batches[0]["pos_mask"].cpu(), cfg64).double()
        off64 = {dev: float((r.detach().cpu().double() - rep64).abs().max())
                 for dev, r in (("card", rep_g), ("cpu", rep_c))}
        print(f"encoder parity {head}: encode's max distance from f64 on the host, card "
              f"{off64['card']:.3g}, CPU {off64['cpu']:.3g}")
        err = max_err(rep_g, rep_c, f"encoder {head}: encode", ENC_REP_RTOL, ENC_REP_ATOL)
        max_err(loss_g, loss_c, f"encoder {head}: step 0 loss", ENC_LOSS0_RTOL, 0.0)
        for (name, _), a, b in zip(cpu.named_parameters(), g_g, g_c):
            max_err(a, b, f"encoder {head}: step 0 gradient of {name}", ENC_GRAD_RTOL,
                    ENC_GRAD_ATOL_FRAC * float(b.abs().max()))
        max_err(torch.tensor(l_g), torch.tensor(l_c), f"encoder {head}: losses", ENC_LOSS_RTOL,
                0.0)
        print(f"encoder parity {head}: card vs CPU, encode max diff {err:.3g} (rtol "
              f"{ENC_REP_RTOL}, atol {ENC_REP_ATOL}); step 0 loss {float(loss_g):.7f} vs "
              f"{float(loss_c):.7f} (rtol {ENC_LOSS0_RTOL}); gradients within rtol "
              f"{ENC_GRAD_RTOL}, atol {ENC_GRAD_ATOL_FRAC} x max; losses of {p['steps']} steps "
              f"{[round(x, 6) for x in l_g]} vs {[round(x, 6) for x in l_c]} "
              f"(rtol {ENC_LOSS_RTOL})")


def encoder_full_width(corpus, device) -> None:
    """DistilBERT's widths on the shard corpus's vocabulary: warm-up and
    timed steps (synchronized host clock), model FLOPs, peak memory; the
    first docs encoded to postings; a checkpoint of the whole train state
    written, waited on and restored, equal bit for bit."""
    f = ENC_FULL
    vocab = corpus.config.n_surface_terms
    cfg = encoder_cfg(f["d_model"], f["n_layers"], vocab)
    torch.cuda.reset_peak_memory_stats()
    model = init_encoder_params(torch.Generator().manual_seed(0), cfg, device=device)
    n_params = sum(x.numel() for x in model.parameters())
    check(n_params == cfg.backbone.n_params(), "encoder params differ from LMConfig.n_params")
    sampler = TripleSampler(corpus, q_len=f["q_len"], d_len=f["d_len"], device=device)
    batches = list(itertools.islice(sampler.batches(f["batch"]), f["warmup"] + f["timed"]))
    step = make_train_step(lambda m, b: encoder_loss(m, b, cfg), AdamWConfig(**ENC_ADAMW))
    state = init_train_state(model)
    losses, ms = [], []
    for i, batch in enumerate(batches):
        sync()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss = float(met["loss"])  # reads the loss: the step has ended
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        check(np.isfinite(loss), f"encoder at full width: step {i} loss {loss} is not finite")
    check(all(bool(torch.isfinite(x).all()) for x in model.parameters()),
          "encoder at full width: a weight is not finite")
    timed = ms[f["warmup"]:]
    flops = (train_step_model_flops(cfg.backbone, f["batch"], f["q_len"])
             + 2 * train_step_model_flops(cfg.backbone, f["batch"], f["d_len"]))
    med = float(np.median(timed))
    print(f"encoder full width: {n_params:,} params (d_model {f['d_model']}, {f['n_layers']} "
          f"layers, {cfg.backbone.n_heads} heads of {cfg.backbone.d_head}, d_ff "
          f"{cfg.backbone.d_ff}, vocab {vocab}), f32, TF32 "
          f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}, remat "
          f"{cfg.backbone.remat}; batch {f['batch']} triples, q_len {f['q_len']}, d_len "
          f"{f['d_len']}")
    print(f"encoder full width: {f['timed']} timed steps after {f['warmup']}: median {med:.2f} ms, "
          f"max {max(timed):.2f} ms a step (host clock, synchronized); "
          f"{1e3 * f['batch'] / med:.1f} triples/s; model FLOPs a step {flops:.4g} "
          f"(train_step_model_flops over the query and both doc sides; remat's recompute not "
          f"counted) = {flops / (med / 1e3) / 1e12:.2f} TFLOP/s, "
          f"{100 * flops / (med / 1e3) / F32_PEAK:.1f}% of the f32 peak {F32_PEAK / 1e12:.0f} "
          f"TFLOP/s; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    holder = [state]

    def one_step():
        holder[0], met = step(holder[0], batches[-1])
        float(met["loss"])

    profile_call("encoder full width: one train step", one_step)
    state = holder[0]

    docs = list(itertools.islice(sampler.doc_token_batches(f["encode_batch"]),
                                 f["encode_docs"] // f["encode_batch"]))
    sync()
    t0 = time.perf_counter()
    d, t, w, n = encode_corpus_to_coo(state.params, [x[0] for x in docs], [x[1] for x in docs],
                                      cfg)
    dt = time.perf_counter() - t0
    check(n == f["encode_docs"] and np.isfinite(w).all() and (w > 1e-4).all()
          and d.dtype == np.int64 and w.dtype == np.float64,
          "encoder full width: encode_corpus_to_coo's output")
    print(f"encoder full width: encode_corpus_to_coo over {n} docs in batches of "
          f"{f['encode_batch']}: {dt:.2f} s, {n / dt:.0f} docs/s (host clock, to host arrays); "
          f"{len(d) / n:.1f} nonzeros a doc")

    line = checkpoint_round_trip(
        state, abstract_train_state(init_encoder_params(None, cfg, "meta")),
        {"phase": "encoder"}, device, "encoder full width")
    print(f"encoder full width: {line}")
    del state, model


# Steps of the example's loop (300 in the example): half, for the run's
# time budget; the loop's checks do not depend on its depth.
ENC_LOOP_STEPS = 150


def encoder_loop(device) -> None:
    """``launch/train_encoder.py``'s ``main`` at the example's settings but
    ``ENC_LOOP_STEPS`` steps, then its learned index's queries through
    SAAT's B1 (fused) and B2 (kernel) routes against the plain sort mode,
    with the counters set to 0 just before and read just after."""
    t0 = time.perf_counter()
    report = train_encoder.main(["--device", str(device), "--steps", str(ENC_LOOP_STEPS)])
    t_main = time.perf_counter() - t0
    hist = report["history"]
    check(all(np.isfinite(h["loss"]) for h in hist), "encoder loop: a loss is not finite")
    check(all(bool(torch.isfinite(x).all()) for x in report["state"].params.parameters()),
          "encoder loop: a weight is not finite")
    index, qt, qw = report["index"], report["q_terms"], report["q_weights"]
    ms = max_segments_per_term(index)
    rho = int(saat_plan(index, qt, qw, ms).total_postings.max())
    swaps = 0
    for lo in range(0, qt.shape[0], BATCH):
        bt, bw = qt[lo:lo + BATCH], qw[lo:lo + BATCH]
        plain = saat_search(index, bt, bw, k=SERVE_K, rho=rho, max_segs_per_term=ms,
                            scatter_impl="sort")
        sync()
        reset_launches()
        routes = {route: saat_search(index, bt, bw, k=SERVE_K, rho=rho, max_segs_per_term=ms,
                                     **kw)
                  for route, kw in (("fused", dict(fused_topk=True)),
                                    ("kernel", dict(scatter_impl="kernel")))}
        sync()
        launches = read_launches()
        check(launches["impact_scatter_topk_segments"] == 1 and launches["impact_scatter"] == 1
              and launches["impact_scatter_topk"] == 0,
              f"encoder loop: B1's segment entry and B2 not each launched once a batch: {launches}")
        for route, res in routes.items():
            what = f"encoder loop {route} batch@{lo}"
            check(torch.equal(res.postings_processed, plain.postings_processed),
                  f"{what}: posting counts differ from the sort mode")
            swaps += tie_swaps(res.scores, res.doc_ids, plain.scores, plain.doc_ids,
                               f"{what} vs sort")
    print(f"encoder loop: main {t_main:.1f} s; {len(hist)} steps, loss "
          f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
          f"RR@10 trained {report['rr_learned']:.4f}, bm25 {report['rr_bm25']:.4f}; postings "
          f"learned {report['index'].n_postings:,}, bm25 {report['bm25_index'].n_postings:,}; "
          f"Lq {qt.shape[1]}; {qt.shape[0]} queries through B1 and B2 at exact rho {rho:,}: "
          f"equal to the sort mode, {swaps} ranks differ in id between near-tied scores; "
          f"impact_scatter_topk's segment entry and impact_scatter each launched "
          f"{-(-qt.shape[0] // BATCH)} times")


def encoder_phase(corpus, device) -> None:
    t0 = time.perf_counter()
    encoder_parity(device)
    t1 = time.perf_counter()
    encoder_full_width(corpus, device)
    t2 = time.perf_counter()
    encoder_loop(device)
    print(f"encoder phase: parity {t1 - t0:.1f} s, full width {t2 - t1:.1f} s, loop "
          f"{time.perf_counter() - t2:.1f} s")


# ---------------------------------------------------------------------------
# the model families (configs/*, archs/*, launch/train.py): every arch's
# smoke config on the card against the CPU; gemma3-1b, granite-moe-3b-a800m,
# GraphCast and dcn-v2 at their published widths; retrieval over the
# retrieval_cand cell's candidates; gemma3-1b's prefill and decode against
# its full forward. Plain PyTorch throughout, as the reference is plain jnp.
# ---------------------------------------------------------------------------

# card against CPU at smoke size, f32, TF32 off: a few ulps apart a product
# (and index_add_ adds with atomics on the card), so the loss within
# ARCH_RTOL, the gradients within ARCH_GRAD_RTOL and an atol of
# ARCH_GRAD_ATOL_FRAC times the leaf's largest gradient, or 1e-3 of the
# model's largest where that is larger (a leaf whose exact gradient is 0,
# as the last bias of DIN's attention MLP, holds rounding noise only); the
# logits of a prefill and its decode steps within ARCH_RTOL of their largest
ARCH_RTOL = 1e-4
ARCH_GRAD_RTOL, ARCH_GRAD_ATOL_FRAC = 1e-4, 1e-5
# smoke batches: LM (batch, seq), GNN (nodes, edges), recsys rows; the LM
# prefill's prompt and decode steps; retrieval candidates and k
ARCH_SMOKE = dict(lm=(2, 32), gnn=(64, 256), recsys=16, prompt=28, decode=4, n_cand=20_000,
                  k=100)
# full width through launch/train.py's main (the published configs, --full)
ARCH_TRAIN = {
    "gemma3-1b": ["--full", "--batch", "2", "--seq", "2048", "--steps", "6"],
    "granite-moe-3b-a800m": ["--full", "--batch", "4", "--seq", "512", "--steps", "4"],
    "dcn-v2": ["--full", "--batch", "65536", "--steps", "4"],
}
ARCH_WARMUP = 2  # steps left out of a median
GRAPHCAST_CELL, GRAPHCAST_STEPS = "full_graph_sm", 4
# GraphCast in bf16 against the card's own f32 run on the same params and
# graph: bf16's unit roundoff is 2^-8 (3.9e-3); 16 residual blocks of two
# products each and the aggregates' bf16 adds, so the node outputs within
# 8 of it in relative L2 norm
GRAPHCAST_BF16_REL = 3e-2
RETRIEVAL_ARCHS = ("dcn-v2", "sasrec")
# gemma3-1b prefill of a 2,048-token prompt into a 4,096-token cache, then
# decode steps; in f32 each step's logits against the full forward of the
# longer prompt within DECODE_REL of the largest logit, argmax equal (or its
# logit within that of the other's); in bf16 timed, also at B = 32
DECODE = dict(batch=2, prompt=2048, cache=4096, steps=32, wide_batch=32, timed_steps=16)
DECODE_REL = 1e-3
BF16_PEAK = 989e12  # H100 SXM dense bf16, FLOP/s


def arch_smoke_batch(spec, cfg) -> dict:
    """A smoke-size batch of the arch's family, on the host."""
    a = ARCH_SMOKE
    if spec.family == "lm":
        return next(lm_token_batches(cfg.vocab, *a["lm"], seed=0, device="cpu"))
    if spec.family == "gnn":
        return next(gnn_batches(cfg, *a["gnn"], seed=0, device="cpu"))
    return next(recsys_batches(cfg, a["recsys"], seed=0, device="cpu"))


def grads_close(g_card, g_cpu, names, what) -> None:
    largest = max(float(g.abs().max()) for g in g_cpu)
    for name, a, b in zip(names, g_card, g_cpu):
        max_err(a, b, f"{what}: gradient of {name}", ARCH_GRAD_RTOL,
                ARCH_GRAD_ATOL_FRAC * max(float(b.abs().max()), 1e-3 * largest))


RETRIEVAL_USER = {"dcn-v2": ("dense", "sparse"), "din": ("hist", "hist_mask"),
                  "sasrec": ("seq", "mask"), "wide-deep": ("sparse",)}


def retrieval_query(batch, kind, n_cand, seed, device) -> dict:
    """The ``retrieval_cand`` layout: the user-side features of the batch's
    first row and ``n_cand`` raw candidate ids drawn from a seed."""
    q = {k: batch[k][:1].to(device) for k in RETRIEVAL_USER[kind]}
    ids = np.random.default_rng(seed).integers(0, 1 << 30, n_cand).astype(np.int32)
    q["candidates"] = torch.as_tensor(ids, device=device)
    return q


def lm_decode_parity(models, tokens, cfg, device, what) -> str:
    """A prefill of the first tokens and decode steps over the rest, on the
    card and on the CPU: the logits of every step against each other."""
    a = ARCH_SMOKE
    logs = {}
    for dev, model in models.items():
        t = tokens.to("cpu" if dev == "cpu" else device)
        logits, cache = lm_prefill(model, t[:, :a["prompt"]], cfg, t.shape[1])
        steps = [logits]
        for i in range(a["prompt"], a["prompt"] + a["decode"]):
            pos = torch.full((t.shape[0],), i, dtype=torch.int32, device=t.device)
            logits, cache = lm_decode_step(model, cache, t[:, i:i + 1], pos, cfg)
            steps.append(logits)
        logs[dev] = torch.stack(steps)
    err = max_err(logs["card"], logs["cpu"], f"{what}: prefill and decode logits", ARCH_RTOL,
                  ARCH_RTOL * float(logs["cpu"].abs().max()))
    return f"prefill of {a['prompt']} + {a['decode']} decode steps, logits max diff {err:.3g}"


def retrieval_parity(models, batch, cfg, device, what) -> str:
    res = {}
    for dev, model in models.items():
        q = retrieval_query(batch, cfg.kind, ARCH_SMOKE["n_cand"], 1,
                            "cpu" if dev == "cpu" else device)
        with torch.no_grad():
            res[dev] = retrieve_topk(model, q, cfg, k=ARCH_SMOKE["k"])
    (s_g, i_g), (s_c, i_c) = res["card"], res["cpu"]
    swaps = tie_swaps(s_g[None], i_g[None], s_c[None], i_c[None], f"{what}: retrieve_topk")
    return (f"retrieve_topk over {ARCH_SMOKE['n_cand']:,} candidates, ids equal but {swaps} "
            f"ranks at near-ties")


def arch_parity(device) -> None:
    """Every arch's smoke config from the same params (drawn on the host)
    and batch on the card and on the CPU, f32: step 0's loss and gradients;
    for the LMs a prefill and 4 decode steps, for the recsys models
    ``retrieve_topk``."""
    for arch_id, spec in ARCHS.items():
        cfg = spec.smoke_config()
        cpu = train_cli._init_params(spec, cfg, torch.Generator().manual_seed(0), "cpu")
        models = {"cpu": cpu, "card": copy.deepcopy(cpu).to(device)}
        loss_fn = train_cli._make_loss(spec, cfg)
        batch = arch_smoke_batch(spec, cfg)
        out = {}
        for dev, model in models.items():
            b = batch if dev == "cpu" else {k: v.to(device) for k, v in batch.items()}
            loss, _ = loss_fn(model, b)
            out[dev] = loss.detach(), torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in cpu.named_parameters()]
        max_err(out["card"][0], out["cpu"][0], f"{arch_id}: step 0 loss", ARCH_RTOL, 0.0)
        grads_close(out["card"][1], out["cpu"][1], names, arch_id)
        line = (f"arch parity {arch_id} ({spec.family}, {cfg.n_params():,} params): step 0 loss "
                f"{float(out['card'][0]):.7f} vs {float(out['cpu'][0]):.7f} (rtol {ARCH_RTOL}), "
                f"{len(names)} gradients within rtol {ARCH_GRAD_RTOL}")
        if spec.family == "lm":
            line += "; " + lm_decode_parity(models, batch["tokens"], cfg, device, arch_id)
        elif spec.family == "recsys":
            line += "; " + retrieval_parity(models, batch, cfg, device, arch_id)
        print(line)


def moe_drop_shares(model, tokens, cfg) -> list:
    """Each MoE layer's share of (token, expert) routes past their expert's
    capacity in one forward of ``tokens``: the layer's dispatch of its own
    input, as ``layers.moe`` computes it (one group on one card)."""
    shares = []

    def count(mod, args):
        x = args[0]
        xt = x.reshape(-1, x.shape[-1])
        C = arch_layers._capacity(xt.shape[0], mod.cfg)
        _, route = arch_layers._dispatch_one_group(xt, xt.float() @ mod.router, mod.cfg, C,
                                                   x.dtype)
        shares.append(1.0 - float(route[1].float().mean()))

    handles = [block.moe.register_forward_pre_hook(count) for block in model.layers]
    try:
        with torch.no_grad():
            lm_hidden_states(model, tokens, cfg)
    finally:
        for h in handles:
            h.remove()
    return shares


def train_line(what, cfg, ms, units, unit, flops, losses, n_params) -> str:
    med = float(np.median(ms))
    peak = BF16_PEAK if cfg.dtype == torch.bfloat16 else F32_PEAK
    rate = flops / (med / 1e3)
    return (f"{what}: {n_params:,} params, {str(cfg.dtype).split('.')[-1]}; {len(ms)} timed "
            f"steps: median {med:.2f} ms, max {max(ms):.2f} ms a step (host clock, "
            f"synchronized); {units / (med / 1e3):,.0f} {unit}/s; model FLOPs a step {flops:.4g} "
            f"= {rate / 1e12:.2f} TFLOP/s, {100 * rate / peak:.1f}% of the "
            f"{'bf16' if peak == BF16_PEAK else 'f32'} peak {peak / 1e12:.0f} TFLOP/s; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}")


def arch_train_full(arch_id, device) -> dict:
    """``launch/train.py``'s ``main`` at the arch's published widths."""
    spec = ARCHS[arch_id]
    argv = ARCH_TRAIN[arch_id]
    torch.cuda.reset_peak_memory_stats()
    report = train_cli.main(["--arch", arch_id, "--device", str(device), *argv])
    cfg, state = report["cfg"], report["state"]
    losses = [float(h["loss"]) for h in report["history"]]
    check(all(np.isfinite(losses)), f"{arch_id} at full width: a loss is not finite: {losses}")
    check(all(bool(torch.isfinite(p).all()) for p in state.params.parameters()),
          f"{arch_id} at full width: a weight is not finite")
    batch = int(argv[argv.index("--batch") + 1])
    if spec.family == "lm":
        seq = int(argv[argv.index("--seq") + 1])
        flops, units, unit = train_step_model_flops(cfg, batch, seq), batch * seq, "tokens"
    else:
        flops, units, unit = recsys_train_flops(cfg, batch), batch, "rows"
    n_params = sum(p.numel() for p in state.params.parameters())
    check(n_params == cfg.n_params(), f"{arch_id}: params differ from the config's count")
    print(train_line(f"{arch_id} full width ({' '.join(argv)})", cfg,
                     report["ms"][ARCH_WARMUP:], units, unit, flops, losses, n_params))
    seq = int(argv[argv.index("--seq") + 1]) if "--seq" in argv else 0
    profile_step(f"{arch_id} full width: one train step", train_cli._make_loss(spec, cfg), state,
                 next(train_cli._make_batches(spec, cfg, batch, seq, device)))
    return report


def profile_step(label, loss_fn, state, batch) -> None:
    """One more train step (after one outside the profile) under
    ``torch.profiler``; it updates ``state``'s module in place."""
    step = make_train_step(loss_fn, AdamWConfig())
    holder = [state]

    def one_step():
        holder[0], met = step(holder[0], batch)
        float(met["loss"])

    profile_call(label, one_step)


def checkpoint_round_trip(state, abstract, meta, device, what) -> str:
    """``state`` written by a ``CheckpointManager`` (async writer, waited on)
    and restored onto ``device`` from the ``abstract`` state: equal bit for
    bit, with its meta. Returns the line's sizes and seconds."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        cm = CheckpointManager(root, keep=1)
        t0 = time.perf_counter()
        cm.save(int(state.step), state, meta)
        t_snap = time.perf_counter() - t0
        cm.wait()
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(dp, fn)) for dp, _, fns in os.walk(root)
                     for fn in fns)
        with open(os.path.join(root, f"step_{int(state.step):09d}", "manifest.json")) as f:
            dtypes = sorted({leaf["dtype"] for leaf in json.load(f)["leaves"]})
        t0 = time.perf_counter()
        restored, got_meta = cm.restore(abstract, device=device)
        sync()
        t_restore = time.perf_counter() - t0
    flat_s, flat_r = flatten_with_paths(state.to_tree())[0], flatten_with_paths(restored.to_tree())[0]
    check([k for k, _ in flat_s] == [k for k, _ in flat_r] and got_meta == meta
          and all(a.dtype == b.dtype and torch.equal(a, b)
                  for (_, a), (_, b) in zip(flat_s, flat_r)),
          f"{what}: the restored train state differs from the saved one")
    del restored
    return (f"checkpoint of the train state ({len(flat_s)} leaves, dtypes {dtypes}, "
            f"{nbytes / 1e9:.3f} GB on disk): save {t_snap:.2f} s to host, {t_save:.2f} s "
            f"written (async writer, waited), restore {t_restore:.2f} s to the card; equal bit "
            f"for bit")


def graphcast_full(device) -> None:
    """GraphCast at the ``full_graph_sm`` cell's sizes (its published 16 x 512
    processor, bf16): the bf16 forward against the card's own f32 run,
    timed train steps, and its train state's checkpoint round trip."""
    spec = ARCHS["graphcast"]
    d = spec.cells[GRAPHCAST_CELL].dims
    cfg = spec.config_for(GRAPHCAST_CELL)
    torch.cuda.reset_peak_memory_stats()
    model = init_gnn_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    batches = list(itertools.islice(gnn_batches(cfg, d["n_nodes"], d["n_edges"], device=device),
                                    GRAPHCAST_STEPS))
    b = batches[0]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    with torch.no_grad():
        outs = [gnn_forward(m, b["node_feats"], b["edge_src"], b["edge_dst"], c,
                            edge_feats=b["edge_feats"]).float()
                for m, c in ((model, cfg), (model32, cfg32))]
    del model32
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    check(rel <= GRAPHCAST_BF16_REL, f"graphcast: bf16 outputs {rel:.3g} from f32 in relative L2, "
                                     f"over {GRAPHCAST_BF16_REL}")
    step = make_train_step(lambda p, bt: gnn_loss(p, bt, cfg),
                           AdamWConfig(warmup_steps=2, total_steps=GRAPHCAST_STEPS))
    state = init_train_state(model)
    ms, losses = [], []
    for bt in batches:
        sync()
        t0 = time.perf_counter()
        state, met = step(state, bt)
        losses.append(float(met["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    check(all(np.isfinite(losses)), f"graphcast at full width: a loss is not finite: {losses}")
    profile_step("graphcast full width: one train step", lambda p, bt: gnn_loss(p, bt, cfg),
                 state, batches[-1])
    n_params = sum(p.numel() for p in model.parameters())
    print(train_line(f"graphcast full width ({GRAPHCAST_CELL}: {d['n_nodes']:,} nodes, "
                     f"{d['n_edges']:,} edges, d_feat {cfg.d_feat}, {cfg.n_layers} x "
                     f"{cfg.d_hidden}, {cfg.aggregator})", cfg, ms[ARCH_WARMUP:], d["n_nodes"],
                     "nodes", gnn_train_flops(cfg, d["n_nodes"], d["n_edges"]), losses, n_params)
          + f"; bf16 outputs {rel:.3g} from the f32 run's in relative L2 (limit "
            f"{GRAPHCAST_BF16_REL})")
    line = checkpoint_round_trip(state, abstract_train_state(abstract_gnn_params(cfg)),
                                 {"arch": "graphcast"}, device, "graphcast")
    print(f"graphcast full width: {line}")


def retrieval_full(arch_id, model, cfg, device) -> None:
    """``retrieve_topk`` over the ``retrieval_cand`` cell's candidates
    (1,000,000 padded to 1,000,448), its ids against a full stable sort of
    ``score_candidates``'s scores but at near-ties; timed (host clock,
    synchronized, median of 3)."""
    n_cand = batch_specs(ARCHS[arch_id], "retrieval_cand")["candidates"].shape[0]
    user = next(recsys_batches(cfg, 1, seed=4, device=device))
    q = retrieval_query(user, cfg.kind, n_cand, 5, device)
    ms = []
    with torch.no_grad():
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            s, ids = retrieve_topk(model, q, cfg)
            sync()
            ms.append(1e3 * (time.perf_counter() - t0))
        full_s, full_i = torch.sort(score_candidates(model, q, cfg), descending=True, stable=True)
    k = s.shape[0]
    swaps = tie_swaps(s[None], ids[None], full_s[None, :k], full_i[None, :k],
                      f"{arch_id}: retrieve_topk against a full sort")
    med = float(np.median(ms[1:]))
    print(f"{arch_id} retrieval: {n_cand:,} candidates, k {k}: median {med:.2f} ms (host clock, "
          f"synchronized, 3 after 1), {n_cand / (med / 1e3):,.0f} candidates/s; ids equal to a "
          f"full stable sort of the scores but {swaps} ranks at near-ties")


def lm_decode_full(device) -> None:
    """gemma3-1b at its published widths: a 2,048-token prompt prefilled into
    a 4,096-token cache, then decode steps, in f32 against the full forward
    of the longer prompt; then timed in bf16 at B = 2 and 32."""
    D = DECODE
    spec = ARCHS["gemma3-1b"]
    P, total = D["prompt"], D["prompt"] + D["steps"]
    cfg32 = dataclasses.replace(spec.config_for("decode_32k"), dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    model = init_lm_params(gen, cfg32, device)
    toks = next(lm_token_batches(cfg32.vocab, D["batch"], total, seed=2, device=device))["tokens"]
    with torch.no_grad():
        full = lm_logits(model, toks, cfg32)  # [B, total, vocab]
    logits, cache = lm_prefill(model, toks[:, :P], cfg32, D["cache"])
    worst, near_ties = 0.0, 0
    for i in range(P - 1, total):
        if i >= P:
            pos = torch.full((D["batch"],), i, dtype=torch.int32, device=device)
            logits, cache = lm_decode_step(model, cache, toks[:, i:i + 1], pos, cfg32)
        want = full[:, i]
        scale = float(want.abs().max())
        diff = float((logits - want).abs().max())
        check(diff <= DECODE_REL * scale, f"gemma3 decode at {i}: logits {diff:.3g} from the full "
                                         f"forward's, over {DECODE_REL} x {scale:.3g}")
        top = logits.argmax(-1)
        same = top == want.argmax(-1)
        near = want.gather(-1, top[:, None])[:, 0] >= want.max(-1).values - DECODE_REL * scale
        check(bool((same | near).all()), f"gemma3 decode at {i}: argmax differs, not a near-tie")
        near_ties += int((~same).sum())
        worst = max(worst, diff / scale)
    print(f"gemma3-1b prefill/decode (f32, TF32 off): prefill of {P} tokens into a "
          f"{D['cache']}-token cache (windows of {cfg32.window_pattern[0]:,} wrap), then "
          f"{D['steps']} decode steps at "
          f"B = {D['batch']}: every step's logits within {worst:.3g} x max |logit| of the full "
          f"forward of the longer prompt (limit {DECODE_REL}); argmax equal but {near_ties} "
          f"near-ties")
    del model, full, cache, logits

    cfg_p = spec.config_for("prefill_32k")  # bf16, attn_chunk 2048
    cfg_d = spec.config_for("decode_32k")
    model = init_lm_params(gen, cfg_p, device)
    for B in (D["batch"], D["wide_batch"]):
        torch.cuda.reset_peak_memory_stats()
        toks = next(lm_token_batches(cfg_p.vocab, B, total, seed=3, device=device))["tokens"]
        pre = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            logits, cache = lm_prefill(model, toks[:, :P], cfg_p, D["cache"])
            sync()
            pre.append(1e3 * (time.perf_counter() - t0))
        dec = []
        for i in range(P, P + D["timed_steps"]):
            pos = torch.full((B,), i, dtype=torch.int32, device=device)
            sync()
            t0 = time.perf_counter()
            logits, cache = lm_decode_step(model, cache, toks[:, i:i + 1], pos, cfg_d)
            sync()
            dec.append(1e3 * (time.perf_counter() - t0))
        check(bool(torch.isfinite(logits).all()), f"gemma3 bf16 decode at B = {B}: not finite")
        profile_call(f"gemma3-1b bf16 decode step at B = {B}",
                     lambda: lm_decode_step(model, cache, toks[:, P:P + 1], pos, cfg_d))
        pre_ms, dec_ms = float(np.median(pre[1:])), float(np.median(dec[1:]))
        flops = decode_step_model_flops(cfg_d, B, P + D["timed_steps"])
        print(f"gemma3-1b bf16 at B = {B}: prefill of {P} tokens into a {D['cache']}-token cache "
              f"{pre_ms:.2f} ms (median of 2 after 1; {B * P / (pre_ms / 1e3):,.0f} tokens/s); "
              f"decode {dec_ms:.3f} ms a step (median of {len(dec) - 1} after 1), "
              f"{B / (dec_ms / 1e3):,.0f} tokens/s, {flops / (dec_ms / 1e3) / 1e12:.2f} TFLOP/s "
              f"of decode_step_model_flops; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del cache, logits
    del model


def free_memory(what) -> None:
    """Drops what is unreachable and prints what stays allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{what}: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card]")


def arch_phase(device) -> None:
    """This slice's path: the model families, plain PyTorch (it launches no
    kernel of the port; the counters are set to 0 before and read after)."""
    clock = PhaseClock()
    reset_launches()
    free_memory("before the model families")
    arch_parity(device)
    clock.end("arch parity")
    for arch_id in ("gemma3-1b", "granite-moe-3b-a800m"):
        free_memory(f"before {arch_id}")
        report = arch_train_full(arch_id, device)
        if arch_id == "granite-moe-3b-a800m":
            cfg = report["cfg"]
            zipf = next(lm_token_batches(cfg.vocab, 4, 512, seed=9, device=device))["tokens"]
            uniform = torch.randint(0, cfg.vocab, (4, 512), device=device,
                                    generator=torch.Generator(device=device).manual_seed(9))
            for what, t in (("a batch of the training stream (Zipf token ids)", zipf),
                            ("a batch of uniform token ids", uniform)):
                shares = 100 * np.array(moe_drop_shares(report["state"].params, t, cfg))
                print(f"granite-moe-3b-a800m: routes dropped past capacity (capacity factor "
                      f"{cfg.moe.capacity_factor}, {cfg.moe.n_experts} experts, top-"
                      f"{cfg.moe.top_k}, one group of 2,048 tokens) in a forward of {what} after "
                      f"the steps: {shares.mean():.2f}% over the {len(shares)} layers (layer 0 "
                      f"{shares[0]:.2f}%, median {np.median(shares):.2f}%, max {shares.max():.2f}%)")
        del report
        clock.end(f"{arch_id} full width")
    free_memory("before graphcast")
    graphcast_full(device)
    clock.end("graphcast full width")
    free_memory("before dcn-v2")
    report = arch_train_full("dcn-v2", device)
    retrieval_full("dcn-v2", report["state"].params, report["cfg"], device)
    del report
    cfg = ARCHS["sasrec"].config_for("retrieval_cand")
    sasrec = init_recsys_params(torch.Generator(device=device).manual_seed(0), cfg, device)
    retrieval_full("sasrec", sasrec, cfg, device)
    del sasrec
    clock.end("dcn-v2 full width and retrieval")
    free_memory("before gemma3 prefill and decode")
    lm_decode_full(device)
    free_memory("after the model families")
    clock.end("gemma3 prefill and decode")
    launches = read_launches()
    print(f"arch phase launches: {launches} (plain PyTorch: no kernel of the port on this path)")
    print(f"arch phase seconds: {json.dumps({k: round(v, 1) for k, v in clock.seconds.items()})}")


# The sharding half: gemma3-1b's train state at its published widths placed
# in process on a (data, model) mesh; the recovery topology; the error-
# feedback steps (batch, sequence) against as many plain ones; the ranks of
# the in-process collectives
SHARD_STATE_MESH = (2, 4)
RECOVERY_TOPOLOGY = elastic.MeshTopology(pods=1, data=2, model=4)
EF_STEPS, EF_BATCH = 3, (2, 512)
EF_ERR_SLACK = 1e-4  # the f32 rounding of x / s and q * s, relative to a step
COLLECTIVE_RANKS = 4
COLLECTIVE_LEAVES = ("embed", "layers.0.mlp.w_up", "layers.0.attn.wq", "layers.0.ln_attn.scale")
DRYRUN_CELLS = (72, 8)  # (plans, skipped) at both production meshes


def placed_check(placed, values, shardings, what) -> str:
    """Every rank's bytes what ``shardings`` give; the blocks reassembled on
    the card equal ``values`` bit for bit. Returns the line's bytes."""
    want = shd.nbytes(values, shardings)
    got = [sum(b.numel() * b.element_size() for _, b in flatten_with_paths(tree)[0])
           for tree in placed]
    check(all(n == want for n in got),
          f"{what}: a rank's bytes {got} differ from train_state_shardings' {want}")
    again = shd.assemble_tree(placed, shardings)
    flat_a, flat_v = flatten_with_paths(again)[0], flatten_with_paths(values)[0]
    check([k for k, _ in flat_a] == [k for k, _ in flat_v]
          and all(a.dtype == v.dtype and torch.equal(a, v.to(a.device))
                  for (_, a), (_, v) in zip(flat_a, flat_v)),
          f"{what}: the reassembled blocks differ from the state")
    total = sum(v.numel() * v.element_size() for _, v in flat_v)
    return (f"{len(placed)} ranks, {want / 2**30:.3f} GiB a rank of {total / 2**30:.3f} GiB; "
            f"reassembled bit for bit")


def error_feedback_run(state, loss_fn, batches, compress, residual) -> tuple:
    """``EF_STEPS`` steps with the error-feedback transform as the trainer's
    ``grad_transform``; each leaf's compression error (the new residual)
    checked within half a quantization step of its block. Returns (state,
    losses, ms a step of the compression)."""
    holder, ms = {"res": residual}, []

    def transform(grads):
        sync()
        t0 = time.perf_counter()
        sent, new_res = compress(grads, holder["res"])
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        for name, g in grads.items():
            corrected = g.float() + holder["res"][name]
            _, scale = collectives.quantize_int8(corrected)
            step = scale.repeat_interleave(collectives.CompressionConfig().block)[
                :corrected.numel()].reshape(corrected.shape)
            check(bool((new_res[name].abs() <= 0.5 * step * (1 + EF_ERR_SLACK)).all()),
                  f"error feedback: {name}'s compression error is over half a step")
        holder["res"] = new_res
        return sent

    step = make_train_step(loss_fn, AdamWConfig(warmup_steps=1), grad_transform=transform)
    state, hist = train_loop(step, state, batches)
    return state, [h["loss"] for h in hist], ms


def collectives_in_process(grads, card) -> None:
    """``compressed_psum`` and ``reduce_scatter_grads`` at
    ``COLLECTIVE_RANKS`` ranks in process: the compressed sum within its int8
    bound of the exact (f64) sum, each rank's reduce-scatter slice the
    rank-ordered sum's, bit for bit."""
    for name, ranks in grads.items():
        sync()
        t0 = time.perf_counter()
        out = collectives.compressed_psum(ranks)
        sync()
        t_psum = 1e3 * (time.perf_counter() - t0)
        exact = torch.stack(ranks).double().sum(0)
        _, s_max = collectives.quantize_int8(torch.stack(ranks).abs().amax(0))
        bound = COLLECTIVE_RANKS * s_max.double().repeat_interleave(
            collectives.CompressionConfig().block)[:exact.numel()]
        err = (out[0].double() - exact).abs().reshape(-1)
        check(all(o is out[0] for o in out) and bool((err <= bound * (1 + EF_ERR_SLACK)).all()),
              f"compressed_psum of {name}: over its int8 bound of the exact sum")
        del exact, bound, err
        t0 = time.perf_counter()
        slices = collectives.reduce_scatter_grads([{name: g} for g in ranks])
        sync()
        t_rs = 1e3 * (time.perf_counter() - t0)
        total = ranks[0]
        for g in ranks[1:]:
            total = total + g
        check(all(torch.equal(sl[name], part) for sl, part in
                  zip(slices, torch.chunk(total, COLLECTIVE_RANKS))),
              f"reduce_scatter_grads of {name}: a slice differs from the rank-ordered sum's")
        print(f"collectives in process, {COLLECTIVE_RANKS} ranks, {name} "
              f"{tuple(ranks[0].shape)} f32: compressed_psum {t_psum:.2f} ms (max error "
              f"{float((out[0] - sum(ranks)).abs().max()):.3g}), reduce_scatter_grads "
              f"{t_rs:.2f} ms (host clock, synchronized; {card})")


def collectives_nccl(grads, device) -> str:
    """The three collectives over an NCCL process group of one rank (a
    FileStore under build/): each equal to the in-process path at one rank;
    the liveness count 1. Returns the backend's name."""
    store = Path(__file__).resolve().parent / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            timeout=timedelta(seconds=120))
    try:
        group = dist.group.WORLD
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        for name, x in grads.items():
            check(torch.equal(collectives.compressed_psum(x, group),
                              collectives.compressed_psum([x])[0]),
                  f"NCCL: compressed_psum of {name} differs from the in-process path")
        tree = dict(grads)
        got = collectives.reduce_scatter_grads(tree, group)
        want = collectives.reduce_scatter_grads([tree])[0]
        check(all(torch.equal(got[k], want[k]) for k in tree),
              "NCCL: reduce_scatter_grads differs from the in-process path")
        live = elastic.data_parallel_liveness(mesh, group=group)
        check(int(live) == 1 == int(elastic.data_parallel_liveness(mesh)),
              f"NCCL: data_parallel_liveness is {int(live)}, not 1")
        return dist.get_backend()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def sharding_phase(device, card) -> None:
    """The sharding half of the distribution layer (plain PyTorch: it
    launches no kernel of the port; the counters are set to 0 before and
    read after)."""
    clock = PhaseClock()
    reset_launches()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out:
        records = dryrun.main(["--all", "--mesh", "both", "--device", str(device), "--out", out])
    counts = (sum(r["status"] == "ok" for r in records),
              sum(r["status"] == "skipped" for r in records))
    check(counts == DRYRUN_CELLS and len(records) == sum(DRYRUN_CELLS),
          f"dry-run: {counts} (ok, skipped) cells, not {DRYRUN_CELLS}")
    print(f"dry-run: {counts[0]} plans, {counts[1]} skipped cells; terms under the NVIDIA H100 "
          f"80GB HBM3 (SXM) peaks, {dryrun.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s bf16 and "
          f"{dryrun.HBM_BW / 1e12:.2f} TB/s a device (spec sheet, not measured)")
    clock.end("dry-run")

    spec = ARCHS["gemma3-1b"]
    cfg = spec.config_for("train_4k")
    loss_fn = train_cli._make_loss(spec, cfg)
    base = init_train_state(init_lm_params(torch.Generator(device=device).manual_seed(0), cfg,
                                           device))
    batches = list(itertools.islice(lm_token_batches(cfg.vocab, *EF_BATCH, seed=3, device=device),
                                    EF_STEPS))
    state = copy.deepcopy(base)
    plain, plain_hist = train_loop(make_train_step(loss_fn, AdamWConfig(warmup_steps=1)), base,
                                   batches)
    plain_losses = [h["loss"] for h in plain_hist]
    del plain, base
    compress, init_res = collectives.make_error_feedback_transform()
    state, ef_losses, ef_ms = error_feedback_run(state, loss_fn, batches, compress,
                                                 init_res(state.params))
    check(all(np.isfinite(plain_losses + ef_losses)), "error feedback: a loss is not finite")
    # step 0 runs the same params on the same batch: equal but for a reduction's order
    check(abs(ef_losses[0] - plain_losses[0]) <= 1e-6 * abs(plain_losses[0]),
          f"error feedback: step 0's loss {ef_losses[0]} differs from {plain_losses[0]}")
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"gemma3-1b full width ({n_params:,} params, bf16; f32 moments), {EF_STEPS} steps at "
          f"B = {EF_BATCH[0]} x {EF_BATCH[1]} tokens: losses with error feedback "
          f"{[round(x, 4) for x in ef_losses]}, without {[round(x, 4) for x in plain_losses]}; "
          f"every leaf's compression error within half a quantization step; the compression "
          f"{np.median(ef_ms):.1f} ms a step (median, host clock, synchronized; {card})")
    clock.end("error feedback")

    values = dataclasses.replace(state, params=dict(state.params.named_parameters()))
    mesh = make_mesh(SHARD_STATE_MESH, ("data", "model"), device=device)
    shardings = shd.train_state_shardings(state, "lm", mesh)
    sync()
    t0 = time.perf_counter()
    placed = shd.place_tree(values, shardings)
    sync()
    t_place = time.perf_counter() - t0
    print(f"gemma3-1b train state on a (data {SHARD_STATE_MESH[0]}, model {SHARD_STATE_MESH[1]}) "
          f"mesh in process: {placed_check(placed, values, shardings, 'state on the mesh')}; "
          f"placed in {t_place:.2f} s ({card})")
    del placed
    clock.end("state on the mesh")

    # the host's copy, placed again on the recovered mesh, is held against
    # the state on the card: a round trip card -> host -> mesh
    t0 = time.perf_counter()
    host = dataclasses.replace(state, params=copy.deepcopy(state.params).cpu(),
                               opt=tree_map(lambda t: t.cpu(), state.opt), step=state.step.cpu())
    t_host = time.perf_counter() - t0
    recovered = elastic.best_effort_mesh(RECOVERY_TOPOLOGY, device=device)
    sync()
    t0 = time.perf_counter()
    placed = elastic.reshard_state(host, "lm", recovered)
    sync()
    t_reshard = time.perf_counter() - t0
    line = placed_check(placed, values, shd.train_state_shardings(host, "lm", recovered),
                        "recovery")
    print(f"recovery: best_effort_mesh({RECOVERY_TOPOLOGY}) with {torch.cuda.device_count()} "
          f"visible device(s) -> {recovered.shape}; reshard_state from the host: {line}; copy "
          f"to the host {t_host:.2f} s, reshard {t_reshard:.2f} s ({card})")
    named = {name: tuple(p.shape) for name, p in state.params.named_parameters()}
    del placed, host, state, values
    free_memory("after the recovery")
    clock.end("recovery")

    gen = torch.Generator(device=device).manual_seed(5)
    grads = {name: [torch.randn(named[name], generator=gen, device=device) * (1 + r)
                    for r in range(COLLECTIVE_RANKS)] for name in COLLECTIVE_LEAVES}
    collectives_in_process(grads, card)
    backend = collectives_nccl({name: ranks[0] for name, ranks in grads.items()}, device)
    print(f"collectives over a {backend} world of one: compressed_psum, reduce_scatter_grads "
          f"and data_parallel_liveness (1) equal to the in-process path")
    del grads
    clock.end("collectives")

    dims = spec.cells["train_4k"].dims
    batch = next(lm_token_batches(cfg.vocab, dims["global_batch"], dims["seq_len"], seed=4,
                                  device="cpu"))
    t0 = time.perf_counter()
    placed = shard_batch(batch, mesh)
    sync()
    t_batch = time.perf_counter() - t0
    line = placed_check(placed, batch, shd.batch_shardings(batch, mesh), "shard_batch")
    print(f"shard_batch of gemma3-1b's train_4k batch {tuple(batch['tokens'].shape)} on the "
          f"{SHARD_STATE_MESH} mesh: {line}; {1e3 * t_batch:.1f} ms ({card})")
    del placed
    free_memory("after the sharding half")
    clock.end("shard_batch")
    launches = read_launches()
    print(f"sharding phase launches: {launches} (plain PyTorch: no kernel of the port on this "
          f"path)")
    print(f"sharding phase seconds: {json.dumps({k: round(v, 1) for k, v in clock.seconds.items()})}")


# ---------------------------------------------------------------------------
# the static analysis on the card
# ---------------------------------------------------------------------------


def mangled_fragment(function: str) -> str:
    """The Itanium-mangled name (length-prefixed, with int/bool template
    arguments) of a ``name<args>`` kernel instance, as it appears in the
    ptxas report and the SASS of the build."""
    name, _, args = function.partition("<")
    out = f"{len(name)}{name}"
    if args:
        parts = []
        for a in args.rstrip(">").split(","):
            a = a.strip()
            parts.append(f"Lb{int(a == 'true')}E" if a in ("true", "false") else f"Li{a}E")
        out += "I" + "".join(parts) + "E"
    return out


def ptxas_report(logs: dict) -> dict:
    """``{kernel: {mangled function: (registers, static smem bytes)}}`` from
    the builds' ``-Xptxas -v`` output."""
    out = {}
    for kernel, log in logs.items():
        fns, current = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                current = line.split("'")[1]
            elif current and "Used" in line and "registers" in line:
                regs = int(line.split("Used")[1].split("registers")[0])
                smem = 0
                for part in line.split(","):
                    if part.strip().endswith("bytes smem"):
                        smem = int(part.split()[0])
                fns[current] = (regs, smem)
                current = None
        out[kernel] = fns
    return out


def cuobjdump() -> str:
    """The toolkit's ``cuobjdump``, or Triton's copy; raises if neither."""
    cands = [Path(common._nvcc()).parent / "cuobjdump"]
    try:
        import triton

        cands.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(f"no cuobjdump (looked at {[str(c) for c in cands]}): cannot read the SASS")


def sass_copies(text: str) -> dict:
    """``{mangled function: (LDGSTS issued, a DEPBAR/LDGDEPBAR after the first)}``
    of a built library's SASS (``cuobjdump -sass``)."""
    out, fn, seen_copy, waited = {}, None, False, False
    for line in text.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if fn is not None:
                out[fn] = (seen_copy, waited)
            fn, seen_copy, waited = line.split("Function :")[1].strip(), False, False
        elif "LDGSTS" in line:
            seen_copy = True
        elif seen_copy and "DEPBAR" in line:
            waited = True
    return out


def main_shape_lint(index, qt, qw) -> None:
    """The hot-path lint once per route on one 64-query batch at the main
    shapes: SAAT fused and scatter kernel at rho = 1M and exact, DAAT split,
    fused and 8 trips a launch, exact. Every route's reads must equal its
    budget (none on the fused SAAT route), the recorder's count the sync
    debug mode's."""
    ms, mb = max_segments_per_term(index), max_blocks_per_term(index)
    routes = [(f"saat {name} rho={rho}", lambda qt, qw, kw=kw, rho=r: saat_search(
                   index, qt, qw, k=SERVE_K, rho=rho, max_segs_per_term=ms, **kw),
               saat_budget(int(r >= index.n_postings and "fused_topk" not in kw)))
              for name, kw in (("fused", dict(fused_topk=True)), ("kernel",
                                                                  dict(scatter_impl="kernel")))
              for rho, r in (("1M", 1_000_000), ("exact", index.n_postings))]
    for mode, flags in DAAT_MODES[1:]:
        routes.append((f"daat {mode} exact", lambda qt, qw, flags=flags: daat_search_batched(
            index, qt, qw, k=SERVE_K, exact=True, max_bm_per_term=mb, **DAAT_KW, **flags),
            daat_budget(True, flags.get("trips_per_launch", 1))))
    bad = []
    for label, fn, budget in routes:
        vs, trace = lint_route(fn, (qt, qw), label, f"B={qt.shape[0]}", budget)
        check(trace is not None, f"main-shape lint {label}: {vs}")
        n, allowed = len(trace.reads()), budget.allowed(trace)
        launches = {}
        for op in find_kernel_calls(trace):
            launches[op.name[7:]] = launches.get(op.name[7:], 0) + 1
        print(f"  main-shape lint {label}: host reads a batch {n} (budget {allowed}: "
              f"{budget.rule}), sync debug {trace.sync_warnings}; kernel launches {launches}; "
              f"{len(trace.ops)} ops; {len(vs)} violations")
        bad += vs
        if n != allowed:
            bad.append(f"{label}: {n} host reads against a budget of {allowed}")
    check(not bad, "main-shape lint: " + "; ".join(str(v) for v in bad))


def plan_checks(contracts, ptxas, n_sms) -> dict:
    """Every contract case's plans: the Python plan equal to the source's C
    plan, the declared static shared memory at least ptxas's, registers x
    threads within an SM's. Returns ``{function: its row}``: registers,
    static bytes, the largest dynamic shared memory over the contract."""
    rows, n_plans = {}, 0
    for name, contract in contracts.items():
        for case in contract.shape_grid:
            for plan in contract.plan(case.dims, n_sms):
                n_plans += 1
                got, want = c_launch_plan(plan), python_launch_plan(plan)
                check(got == want, f"{name} {case.name}: the C plan {got} is not the Python plan "
                                   f"{want}")
                frag = mangled_fragment(plan.function)
                hits = [v for f, v in ptxas[plan.kernel].items() if frag in f]
                check(len(hits) == 1, f"{plan.function}: {len(hits)} ptxas entries match {frag}")
                regs, static = hits[0]
                declared = sum(b for _, b in plan.static_smem)
                check(declared >= static, f"{plan.function}: {declared} B of static shared memory "
                                          f"declared, ptxas reports {static}")
                check(regs * plan.threads <= REGISTERS_PER_SM,
                      f"{plan.function}: {regs} registers x {plan.threads} threads")
                row = rows.setdefault(plan.function, dict(
                    kernel=plan.kernel, registers=regs, static=static, declared=declared,
                    max_dynamic=0, threads=set()))
                row["max_dynamic"] = max(row["max_dynamic"], sum(b for _, b in plan.smem))
                row["threads"].add(plan.threads)
    print(f"  {n_plans} launch plans: the Python plan equal to the C plan at every case")
    return rows


def sass_checks(contracts, dumps, rows) -> None:
    """The SASS of every kernel of a library: LDGSTS exactly where its
    contract expects async copies, each followed by a DEPBAR; then a line a
    function launched at the contract's cases."""
    sass = {}
    for k, (proc, out) in dumps.items():
        check(proc.wait(timeout=120) == 0, f"cuobjdump -sass of {k} failed")
        out.seek(0)
        sass[k] = sass_copies(out.read().decode())
    for name, contract in contracts.items():
        for fn, (copies, waited) in sass[contract.source or name].items():
            check(copies == contract.expect_async_copy,
                  f"{name}: SASS of {fn} {'has' if copies else 'has no'} LDGSTS, the contract "
                  f"expects {contract.expect_async_copy}")
            check(waited or not copies, f"{name}: SASS of {fn} has no DEPBAR after its LDGSTS")
    for fn, row in sorted(rows.items()):
        copies = any(c for f, (c, _) in sass[row["kernel"]].items() if mangled_fragment(fn) in f)
        print(f"  ptxas {fn}: {row['registers']} registers, {row['static']} B static shared "
              f"memory (declared {row['declared']}), up to {row['max_dynamic']} B dynamic over "
              f"the contract, threads {sorted(row['threads'])}; SASS LDGSTS "
              f"{'yes' if copies else 'no'}")


def start_sass_dumps() -> dict:
    """``cuobjdump -sass`` of every built library, each into a file, started
    (niced) right after the build so that they run beside the phases before
    the analysis reads them; any still running at exit is stopped."""
    tool = cuobjdump()
    dumps = {}
    for k in common.kernel_names():
        out = tempfile.TemporaryFile()
        dumps[k] = (subprocess.Popen(["nice", "-n", "10", tool, "-sass", str(common._lib_path(k))],
                                     stdout=out), out)
    atexit.register(stop_sass_dumps, dumps)
    return dumps


def stop_sass_dumps(dumps) -> None:
    for proc, out in dumps.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        out.close()


def analysis_phase(index, qt, qw, device, dumps) -> None:
    """``repro_torch.analysis`` on the card: every contract at its cases
    (each launched, wrappers under the sync debug mode's "error"), every
    plan against its C plan and the ptxas report (:func:`plan_checks`), the
    SASS (:func:`sass_checks`, of ``dumps``: :func:`start_sass_dumps`), the serving lint
    (every route held to its host-read budget, the recorder against the
    sync debug mode) and the lint at the main shapes. Any violation fails
    the run."""
    t0 = time.perf_counter()
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t0 - sum(seconds.values())

    contracts = all_contracts()
    violations = analysis_check.run_kernel_checks(device=device)
    rows = plan_checks(contracts, ptxas_report(common.build_kernels()),
                       common.sm_count(device.index or 0))
    lap("contracts and plans")
    violations += analysis_check.run_serving_checks(device=device)
    violations += analysis_check.run_daat_phase0_checks(device)
    check(not violations, "analysis: " + "; ".join(str(v) for v in violations))
    lap("serving")
    sass_checks(contracts, dumps, rows)
    stop_sass_dumps(dumps)
    lap("SASS")
    main_shape_lint(index, qt, qw)
    lap("main shapes")
    print(f"analysis phase: 0 violations in {time.perf_counter() - t0:.1f} s "
          f"({json.dumps({k: round(v, 1) for k, v in seconds.items()})})")


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
    cpus = [line.split(":", 1)[1].strip() for line in open("/proc/cpuinfo")
            if line.startswith("model name")]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"f32 matmul TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}; host "
          f"{cpus[0] if cpus else 'unknown'} x {len(cpus)}, torch threads {torch.get_num_threads()}")
    t0 = time.perf_counter()
    logs = common.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    dumps = start_sass_dumps()
    # The analysis phase records ops under a TorchDispatchMode, whose first
    # dispatch imports torch._dynamo (9 s on the card's host): import it here.
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    print(f"torch._dynamo import (the op recorder's): {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    phase.end("kernel build")

    err_s, err_t = contract_phases(device, args.seed)
    scatter_edge_phases(device, args.seed)
    scatter_range_edges(device, args.seed)
    daat_errs = daat_contract_phases(device, args.seed)
    phase.end("kernel contracts")
    corpus, data, encs = make_data(args.n_docs, args.n_queries, args.seed, device)
    phase.end("corpus and index builds")
    index, qt, qw = data[MAIN_SHAPE[0]]
    rng = np.random.default_rng(args.seed)
    live = torch.as_tensor(rng.random(index.doc_terms.shape[0]) < 0.9, dtype=torch.int32,
                           device=device)
    rows = main_shape_phases(index, qt[:BATCH], qw[:BATCH], live)
    rows.update(daat_main_shape_phases(index, qt[:BATCH], qw[:BATCH], live))
    phase.end("kernels at the main shapes")
    analysis_phase(index, qt[:BATCH], qw[:BATCH], device, dumps)
    phase.end("analysis")
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

    # the weight analysis over every query of both shards, and the frontier
    # of this run's operating points
    wacky_phase(data, {m: enc.weights for m, enc in encs.items()}, SERVE_K)
    frontier_phase(data, np.asarray(corpus.qrels), rr, latency, d_results, d_latency)
    phase.end("weight analysis")
    # the encoder and the model families keep their own peaks; the paths' peak
    # resumes after
    paths_peak = torch.cuda.max_memory_allocated()
    encoder_phase(corpus, device)
    phase.end("encoder")
    arch_phase(device)
    phase.end("model families")
    sharding_phase(device, card)
    torch.cuda.reset_peak_memory_stats()
    phase.end("sharding half")

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
    sharded_phase(encs[MAIN_SHAPE[0]], index, qt, qw, live, results, d_results, qrels,
                  rr[f"{MAIN_SHAPE[0]} k={SERVE_K} rho=1000000"], args.seed, card)
    phase.end("sharded serving")
    vmap_phase(index, qt[:BATCH], qw[:BATCH])
    phase.end("saat_search_vmap")
    launches.update(single_query_phase(index, qt[:BATCH], qw[:BATCH]))
    for name, batched in SINGLE_KERNELS.items():
        rows[name] = [r for r in rows[batched] if r["what"].startswith("main B=1")]
    phase.end("single-query wrappers")
    peak = max(paths_peak, torch.cuda.max_memory_allocated())
    print(f"peak device memory (the serving paths; the encoder and model-family phases apart): {peak / 1e9:.2f} GB")

    errs = {
        "impact_scatter": max([err_s] + [r["max_abs_err"] for r in rows["impact_scatter"]]),
        "impact_scatter_topk": max([err_t] + [r["max_abs_err"] for r in rows["impact_scatter_topk"]]),
        "impact_scatter_topk_segments": 0.0,  # equal bit for bit
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
    ap.add_argument("--saat-cell", action="store_true",
                    help="only B1's segment entry at the spladev2-saat-open cell's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.saat_cell:
        print(gpu_name_and_limit())
        saat_cell_phase(args.seed, torch.device("cuda"))
        print(json.dumps({"ok": True}))
        return
    run(args, torch.device("cuda"))


if __name__ == "__main__":
    main()
