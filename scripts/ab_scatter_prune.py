#!/usr/bin/env python3
"""Time ``impact_scatter`` (B2) and the dense ``block_prune`` (B8) of one
checkout against another's, on the same inputs, on one GPU.

    python3 scripts/ab_scatter_prune.py make  --out INPUTS.pt [--seed N]
    python3 scripts/ab_scatter_prune.py time  --src DIR --inputs INPUTS.pt --tag NAME
    python3 scripts/ab_scatter_prune.py sweep --inputs INPUTS.pt

``make`` builds the ``spladev2`` index of one 276,307-doc shard (the shard
``chip_smoke.py`` serves) with this checkout's ``repro_torch``, gathers one
64-query batch at rho = 1M and 100k in the scatter kernels' input layout,
densifies the batch's block maxima for B8, and saves the kernels' inputs.

``time`` imports ``repro_torch`` from ``DIR/src`` (another checkout, e.g. a
``git archive`` of a parent commit unpacked under ``build/``), builds its
two kernels there and calls their launchers (``impact_scatter_launch`` and
``block_prune_launch``, the same signature in every version) at B = 64 and
B = 1 of each shape. It prints one JSON line a row: CUDA events around back
-to-back calls (``ms``), 50 calls replayed from one CUDA graph
(``graph_ms``), the same with inputs the L2 cannot hold (``cold_ms``: the
graph's calls rotate over copies of twice the L2's bytes), the host's
enqueue time a launch at B = 1 (``host_us``: the median of 7 runs of 1,000
launches timed with ``time.perf_counter``, no synchronise inside), the
library yardstick's (``scatter_add_``, ``torch.bmm``) beside each, and a
hash of the kernel's output, so two checkouts can be held to the same
bits. Run the two checkouts in turns on one machine, in one command
(parent, change, change, parent): two machines may differ.

``sweep`` times this checkout's kernels at every launch layout on the same
inputs, replayed from a CUDA graph: B2 at each (slots a range, ranges a
CTA), B8 at each tile, each output equal to the wrapper's own choice's.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_DOCS = 276_307
N_QUERIES = 64
RHOS = (1_000_000, 100_000)
L2_BYTES = 50e6


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_of(calls) -> float:
    """Mean device time of the calls captured in one CUDA graph and replayed."""
    for c in calls[:2]:
        c()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / len(calls)


def cold_ms(call, inputs) -> float:
    nbytes = sum(t.numel() * t.element_size() for t in inputs)
    copies = max(2, int(np.ceil(2 * L2_BYTES / nbytes)))
    sets = [tuple(t.clone() for t in inputs) for _ in range(copies)]
    return graph_of([lambda a=a: call(*a) for a in sets] * max(1, -(-50 // copies)))


def host_us(fn, n: int = 1000, reps: int = 7) -> float:
    """Median over ``reps`` runs of the host's microseconds a call over
    ``n`` calls with no synchronise inside."""
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


def digest(*tensors) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def make(args) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import (block_upper_bounds, build_impact_index, max_blocks_per_term,
                                  max_segments_per_term, pad_queries, saat_plan)
    from repro_torch.core.daat import _dense_blockmax_rows
    from repro_torch.core.saat import _gather_postings_batched
    from repro_torch.data.synthetic import CorpusConfig, generate_corpus
    from repro_torch.kernels import common
    from repro_torch.models.treatments import apply_treatment

    dev = torch.device("cuda")
    corpus = generate_corpus(CorpusConfig(n_docs=N_DOCS, n_queries=N_QUERIES, seed=args.seed))
    enc = apply_treatment(corpus, "spladev2", seed=args.seed)
    index = build_impact_index(enc.doc_idx, enc.term_idx, enc.weights, corpus.n_docs,
                               enc.n_terms, device=dev)
    qt, qw = pad_queries(enc.query_terms, enc.query_weights,
                         max(len(t) for t in enc.query_terms), enc.n_terms)
    qt, qw = torch.as_tensor(qt, device=dev), torch.as_tensor(qw, device=dev)
    plan = saat_plan(index, qt, qw, max_segments_per_term(index))
    pad = common.round_up(index.n_docs, 512)
    out = {"n_docs_pad": pad}
    for rho in RHOS:
        docs, contribs, _ = _gather_postings_batched(index, plan, rho)
        out[f"scatter_{rho}"] = common.sorted_posting_tiles(docs, contribs, pad, 512)
    mb = max_blocks_per_term(index)
    ub = block_upper_bounds(index, qt, qw, mb)
    out["prune"] = (_dense_blockmax_rows(index, qt, qw, mb), qw.float().contiguous(),
                    ub.median(dim=-1).values.contiguous())
    torch.save(out, args.out)
    print(json.dumps({"made": args.out, "shapes": {k: [list(t.shape) for t in v]
                                                   for k, v in out.items() if k != "n_docs_pad"}}))


def time_rows(args) -> None:
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels.block_prune import ops as prune_ops
    from repro_torch.kernels.impact_scatter import ops as scatter_ops

    data = torch.load(args.inputs, map_location="cuda")
    pad = data["n_docs_pad"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for rho in RHOS:
        docs_all, c_all = data[f"scatter_{rho}"]
        for B in (docs_all.shape[0], 1):
            docs, c = docs_all[:B].contiguous(), c_all[:B].contiguous()
            keys = docs.long()

            def call(d, v):
                return scatter_ops.impact_scatter_launch(d, v, pad, 512)

            def library(k=keys, v=c, B=B):
                return torch.zeros((B, pad + 1), device=v.device).scatter_add_(1, k, v)

            rows.append(dict(kernel="impact_scatter", shape=[B, int(docs.shape[1]), pad], rho=rho,
                             **measure(lambda d=docs, v=c: call(d, v), library, call, (docs, c),
                                       B == 1)))
    bm_all, qw_all, th_all = data["prune"]
    for B in (bm_all.shape[0], 1):
        bm, qw, th = bm_all[:B].contiguous(), qw_all[:B].contiguous(), th_all[:B].contiguous()
        kernel = lambda a=bm, w=qw, t=th: prune_ops.block_prune_launch(a, w, t)  # noqa: E731
        library = lambda a=bm, w=qw: torch.bmm(w[:, None], a)  # noqa: E731
        rows.append(dict(kernel="block_prune", shape=list(bm.shape),
                         **measure(kernel, library, prune_ops.block_prune_launch, (bm, qw, th),
                                   B == 1)))
        if B == 1 and hasattr(prune_ops.common, "launcher"):
            rows[-1]["host_parts_us"] = host_parts(prune_ops, bm, qw, th)
    for r in rows:
        print(json.dumps(dict(tag=args.tag, card=card, **r)))


def sweep(args) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels.block_prune import ops as prune_ops
    from repro_torch.kernels.impact_scatter import ops as scatter_ops

    data = torch.load(args.inputs, map_location="cuda")
    pad = data["n_docs_pad"]
    chosen = scatter_ops.range_layout
    for rho in RHOS:
        docs_all, c_all = data[f"scatter_{rho}"]
        for B in (docs_all.shape[0], 1):
            docs, c = docs_all[:B].contiguous(), c_all[:B].contiguous()
            want = scatter_ops.impact_scatter_launch(docs, c, pad, 512)
            times = {}
            for spt in scatter_ops.SLOTS_PER_THREAD:
                for stages in scatter_ops.STAGES:
                    scatter_ops.range_layout = lambda *a, lay=(spt, stages): lay
                    got = scatter_ops.impact_scatter_launch(docs, c, pad, 512)
                    assert torch.equal(got, want), (rho, B, spt, stages)
                    times[f"{scatter_ops.THREADS * spt}x{stages}"] = graph_of(
                        [lambda: scatter_ops.impact_scatter_launch(docs, c, pad, 512)] * 20)
            scatter_ops.range_layout = chosen
            print(json.dumps(dict(kernel="impact_scatter", rho=rho, B=B,
                                  layout=chosen(B, int(docs.shape[1]), pad, 132), graph_ms=times)))
    bm_all, qw_all, th_all = data["prune"]
    for B in (bm_all.shape[0], 1):
        args3 = tuple(t[:B].contiguous() for t in (bm_all, qw_all, th_all))
        want = prune_ops.block_prune_launch(*args3)
        times = {}
        for tile in prune_ops.TILES:
            got = prune_ops.block_prune_launch(*args3, tile=tile)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (B, tile)
            times[tile] = graph_of([lambda: prune_ops.block_prune_launch(*args3, tile=tile)] * 50)
        print(json.dumps(dict(kernel="block_prune", B=B, tile=prune_ops.PRUNE_TILE,
                              graph_ms=times)))


def host_parts(prune_ops, bm, qw, th) -> dict:
    """Where B8's host time goes (a checkout with ``common.launcher``): the
    two outputs' allocation, the bound C launcher called with ready ints,
    the checks, and the read of the current stream."""
    common = prune_ops.common
    B, lq, nb = bm.shape
    ub, sv = prune_ops.block_prune_launch(bm, qw, th)
    fn = common.launcher("block_prune", "block_prune_launch", 5, 4)
    ints = (bm.data_ptr(), qw.data_ptr(), th.data_ptr(), ub.data_ptr(), sv.data_ptr(), B, lq, nb,
            prune_ops.PRUNE_TILE, common.stream_handle(bm.get_device()))

    def checks():
        common.check_cuda_tensors(bm, qw, th)
        common.check_dtypes(blockmax=(bm, torch.float32), q_weights=(qw, torch.float32),
                            theta=(th, torch.float32))

    def alloc():
        return bm.new_empty((B, nb)), bm.new_empty((B, nb), dtype=torch.bool)

    return dict(alloc=host_us(alloc), c_launcher=host_us(lambda: fn(*ints)),
                checks=host_us(checks),
                stream=host_us(lambda: common.stream_handle(bm.get_device())))


def measure(kernel, library, call, inputs, single) -> dict:
    out = kernel()
    sync()
    row = dict(sha=digest(*(out if isinstance(out, tuple) else (out,))),
               ms=cuda_ms(kernel), graph_ms=graph_of([kernel] * 50), cold_ms=cold_ms(call, inputs),
               library_ms=cuda_ms(library), library_graph_ms=graph_of([library] * 50))
    if single:
        row.update(host_us=host_us(kernel), library_host_us=host_us(library))
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("--out", required=True)
    mk.add_argument("--seed", type=int, default=0)
    tm = sub.add_parser("time")
    tm.add_argument("--src", required=True, help="checkout whose src/repro_torch to time")
    tm.add_argument("--inputs", required=True)
    tm.add_argument("--tag", required=True)
    sw = sub.add_parser("sweep")
    sw.add_argument("--inputs", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dict(make=make, time=time_rows, sweep=sweep)[args.cmd](args)


if __name__ == "__main__":
    main()
