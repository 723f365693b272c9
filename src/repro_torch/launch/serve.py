"""Serving driver: ``python -m repro_torch.launch.serve [...]``.

The port of ``repro.launch.serve``, with the same flags plus ``--device``:
it serves on the GPU (``cuda``, the default) and raises when there is none,
unless ``--device cpu`` asks for the plain PyTorch path on the host.

End-to-end anytime retrieval: synthetic corpus -> retrieval-model treatment
-> impact index -> batched SAAT serving with the deadline->rho controller.
Prints effectiveness (RR@10) + the full latency distribution (tail latency is
the paper's headline serving metric).

``--queue`` switches from pre-formed batches to arrival-driven serving: a
seeded Poisson request stream (``--arrival-qps``) flows through the
continuous-batching ``AdmissionQueue`` on a ``HybridClock`` (scripted
arrivals + real measured service times), and the report adds queue-wait
percentiles, per-bucket flush counts, and the deadline-policy violation
count — which is falsifiable here, since service time genuinely consumes
deadline budget. ``--lq-buckets`` turns on Lq-bucketed batch shapes in
either mode. (The fully deterministic SimulatedClock variant of this loop
lives in tests/test_torch_queue.py.)

``--mutate-qps`` layers a seeded Poisson *mutation* stream (adds / updates /
deletes over an ``IndexHandle``) onto the arrival stream: the replay runs on
a ``SimulatedClock`` through :func:`repro_torch.serving.lifecycle.replay_with_churn`
with threshold compaction hot-swapping new generations between flushes. The
report then adds the churn ledger: per-op counts, compactions, the final
generation, and the generation span observed across flushes.

``--counters-port`` starts a Prometheus-style scrape endpoint
(``GET /metrics``) on localhost for the duration of the run: each scrape
derives the counter families fresh from the live server/queue objects —
including the index lifecycle gauges (``repro_index_generation``,
``repro_index_tombstones``, ``repro_index_delta_docs``) when the corpus is
mutable. Port 0 picks an ephemeral port (printed to stderr).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import build_impact_index, pad_queries
from repro_torch.data.synthetic import CorpusConfig, generate_corpus
from repro_torch.device import resolve_device
from repro_torch.metrics.ir_metrics import mrr_at_k
from repro_torch.metrics.latency import HybridClock, summarize_latencies
from repro_torch.models.treatments import MODEL_NAMES, apply_treatment
from repro_torch.serving import AnytimeServer, ServingConfig, run_query_stream
from repro_torch.serving.queue import AdmissionQueue, replay_arrivals


def _csv_ints(text: str) -> tuple[int, ...]:
    try:
        return tuple(int(x) for x in text.split(",") if x.strip())
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"expected comma-separated ints, got {text!r}") from e


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="spladev2", choices=list(MODEL_NAMES))
    ap.add_argument("--docs", type=int, default=20000)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--rho", type=int, default=None, help="fixed posting budget (overrides deadline)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument(
        "--engine", default="saat", choices=("saat", "daat"),
        help="saat = anytime rho-budgeted; daat = batched Block-Max pruning",
    )
    ap.add_argument("--daat-est-blocks", type=int, default=8)
    ap.add_argument("--daat-block-budget", type=int, default=16)
    ap.add_argument(
        "--fused-topk", action="store_true",
        help="SAAT: fuse top-k into the scatter kernel (the accumulator never reaches device memory)",
    )
    ap.add_argument(
        "--daat-use-kernels", action="store_true",
        help="DAAT: route phases 0-2 through the CUDA kernels",
    )
    ap.add_argument(
        "--daat-fused-chunk", action="store_true",
        help="DAAT: fuse each phase-2 trip's select+score+merge into one "
        "chunk_step launch (needs --daat-use-kernels)",
    )
    ap.add_argument(
        "--daat-trips-per-launch", type=int, default=1, metavar="N",
        help="DAAT: batch up to N phase-2 trips inside one fused chunk_step "
        "launch (pool/theta cross device memory once per launch; needs "
        "--daat-fused-chunk)",
    )
    ap.add_argument(
        "--lq-buckets", type=_csv_ints, default=None, metavar="W1,W2,...",
        help="Lq bucket widths: pad each batch to the smallest covering "
        "bucket (one batch shape per (config, bucket); bit-identical results)",
    )
    ap.add_argument(
        "--queue", action="store_true",
        help="serve a Poisson arrival stream through the continuous-batching "
        "AdmissionQueue (scripted arrivals, real measured service times)",
    )
    ap.add_argument("--arrival-qps", type=float, default=2000.0, help="Poisson arrival rate")
    ap.add_argument(
        "--request-deadline-ms", type=float, default=25.0,
        help="per-request completion deadline for the admission queue",
    )
    ap.add_argument(
        "--queue-shapes", type=_csv_ints, default=(8, 32), metavar="B1,B2,...",
        help="allowed flush batch shapes for the admission queue",
    )
    ap.add_argument(
        "--queue-safety-ms", type=float, default=2.0,
        help="flush headroom before each due instant (absorbs host dispatch cost)",
    )
    ap.add_argument(
        "--degrade-rho", action="store_true",
        help="SAAT + --queue: a flush that can no longer meet the oldest "
        "deadline at the full budget degrades to the largest calibrated rho "
        "that still fits (degradation replaces violation; served levels are "
        "reported per flush)",
    )
    ap.add_argument(
        "--eval-qrels", action="store_true",
        help="report the effectiveness ledger against the synthetic corpus "
        "qrels: Recall/MRR/NDCG per rho level vs the exact budget (direct "
        "mode) or per rho actually served (--queue mode), plus the smallest "
        "rho within 3%% MRR loss",
    )
    ap.add_argument(
        "--queue-max-wait-s", type=float, default=None,
        help="age-based flush bound: a bucket flushes no later than "
        "oldest-arrival + this many seconds (keeps deadline-less traffic "
        "from starving in a never-full bucket)",
    )
    ap.add_argument(
        "--mutate-qps", type=float, default=None, metavar="QPS",
        help="with --queue: interleave a seeded Poisson mutation stream "
        "(adds/updates/deletes on an IndexHandle) with the arrival stream; "
        "threshold compaction hot-swaps generations between flushes. Runs "
        "the deterministic SimulatedClock replay (service wall time is not "
        "measured in this mode)",
    )
    ap.add_argument(
        "--compact-delta-docs", type=int, default=64, metavar="N",
        help="churn replay: compact once the delta segment holds N docs "
        "(the tombstone-fraction trigger uses the policy defaults)",
    )
    ap.add_argument(
        "--counters-port", type=int, default=None, metavar="PORT",
        help="serve the counter families at http://127.0.0.1:PORT/metrics "
        "for the duration of the run (0 = ephemeral port, printed to stderr)",
    )
    ap.add_argument(
        "--counters-linger-s", type=float, default=0.0, metavar="S",
        help="keep the --counters-port endpoint up S seconds after the "
        "report prints (for external scrapers)",
    )
    ap.add_argument(
        "--counters", action="store_true",
        help="export the serving counter families (Prometheus text exposition "
        "to stderr, structured copy under report['counters']); with --queue "
        "this includes the admission-queue flush/violation/served-rho "
        "families, otherwise the server-side families only",
    )
    ap.add_argument("--seed", type=int, default=0, help="arrival-schedule RNG seed")
    ap.add_argument(
        "--device", default="cuda",
        help="where the index lives and the engines run: cuda (default; raises "
        "without a GPU) or cpu (the kernels' plain PyTorch versions)",
    )
    args = ap.parse_args(argv)
    if args.queue and args.lq_buckets is None:
        ap.error("--queue needs --lq-buckets (the queue coalesces onto the bucket grid)")
    if args.fused_topk and args.engine != "saat":
        ap.error("--fused-topk is a SAAT scatter fusion; use --engine saat")
    if args.daat_use_kernels and args.engine != "daat":
        ap.error("--daat-use-kernels selects DAAT kernels; use --engine daat")
    if args.daat_fused_chunk and not args.daat_use_kernels:
        ap.error("--daat-fused-chunk fuses the kernel chunk step; add --daat-use-kernels")
    if args.daat_trips_per_launch < 1:
        ap.error("--daat-trips-per-launch must be >= 1")
    if args.daat_trips_per_launch > 1 and not args.daat_fused_chunk:
        ap.error(
            "--daat-trips-per-launch > 1 batches trips inside the fused "
            "chunk_step kernel; add --daat-fused-chunk"
        )
    if args.engine == "daat" and (args.deadline_ms is not None or args.rho is not None):
        ap.error("--deadline-ms/--rho are SAAT budgets; the daat engine cannot honor them")
    if args.degrade_rho and not args.queue:
        ap.error("--degrade-rho is a flush-time policy of the admission queue; add --queue")
    if args.degrade_rho and args.engine != "saat":
        ap.error("--degrade-rho trades the SAAT posting budget; use --engine saat")
    if args.mutate_qps is not None and not args.queue:
        ap.error("--mutate-qps interleaves mutations with queue flushes; add --queue")
    if args.mutate_qps is not None and args.mutate_qps <= 0:
        ap.error("--mutate-qps must be positive")
    if args.counters_port is not None and not args.counters:
        ap.error("--counters-port scrapes the counter families; add --counters")
    device = resolve_device(args.device)  # no GPU and no --device cpu: raise now

    corpus = generate_corpus(CorpusConfig(n_docs=args.docs, n_queries=args.queries))
    enc = apply_treatment(corpus, args.model)
    max_q = max(len(t) for t in enc.query_terms)
    qt, qw = pad_queries(enc.query_terms, enc.query_weights, max_q, enc.n_terms)

    ladder = (args.rho,) if args.rho else (100_000, 500_000, 1_000_000, 5_000_000)
    cfg = ServingConfig(
        k=args.k, rho_ladder=ladder, batch_size=args.batch,
        deadline_ms=args.deadline_ms, engine=args.engine,
        fused_topk=args.fused_topk,
        daat_est_blocks=args.daat_est_blocks, daat_block_budget=args.daat_block_budget,
        daat_use_kernels=args.daat_use_kernels,
        daat_fused_chunk=args.daat_fused_chunk,
        daat_trips_per_launch=args.daat_trips_per_launch,
        lq_buckets=args.lq_buckets,
    )
    if args.queue and args.mutate_qps is not None:
        _serve_churn(args, corpus, enc, cfg, qt, qw, device)
        return
    index = build_impact_index(
        enc.doc_idx, enc.term_idx, enc.weights, corpus.n_docs, enc.n_terms, device=device
    )
    if args.queue:
        _serve_queue(args, corpus, index, enc, cfg, qt, qw)
        return
    server = AnytimeServer(index, cfg)
    endpoint = _maybe_counters_endpoint(args, server)
    server.warmup(qt[: args.batch], qw[: args.batch])
    server.reset_stats()
    scores, ids = run_query_stream(server, qt, qw)
    stats = server.stats()
    report = {
        "model": args.model,
        "n_docs": corpus.n_docs,
        "n_postings": index.n_postings,
        "rr@10": round(mrr_at_k(ids, corpus.qrels, 10), 4),
        "latency": {k: round(v, 3) for k, v in stats.row().items()},
        "tail_ratio_p99_p50": round(stats.tail_ratio, 2),
    }
    if args.eval_qrels:
        if args.engine != "saat":
            raise SystemExit("--eval-qrels sweeps the SAAT rho ladder; use --engine saat")
        from repro_torch.metrics.ir_metrics import cheapest_rho_within_loss, rho_effectiveness_sweep

        sweep = rho_effectiveness_sweep(
            server, qt, qw, np.asarray(corpus.qrels),
            recall_k=min(args.k, 100), batch_size=args.batch,
        )
        report["effectiveness_by_rho"] = [
            {k: (round(v, 4) if isinstance(v, float) else v) for k, v in row.items()}
            for row in sweep
        ]
        report["rho_within_3pct_mrr_loss"] = cheapest_rho_within_loss(sweep, max_loss=0.03)
    if args.counters:
        report["counters"] = _export_counters(server)
    print(json.dumps(report, indent=1))
    _close_counters_endpoint(args, endpoint)


def _serve_queue(args, corpus, index, enc, cfg: ServingConfig, qt, qw) -> None:
    """Arrival-driven serving: scripted Poisson arrivals, real service times.

    The HybridClock accrues measured wall time between events, so the cost
    model calibrates on real service cost and the reported
    deadline_policy_violations count is falsifiable (a slow flush really
    shows up); arrivals follow the seeded schedule, so the *load shape* is
    reproducible even though wall times are not.
    """
    clock = HybridClock()
    server = AnytimeServer(index, cfg, clock=clock)
    queue = AdmissionQueue(
        server,
        batch_shapes=args.queue_shapes,
        clock=clock,
        safety_ms=args.queue_safety_ms,
        max_wait_s=args.queue_max_wait_s,
        degrade_rho=args.degrade_rho,
    )
    # endpoint up before the (slow) warmup so scrapers see the whole run
    endpoint = _maybe_counters_endpoint(args, server, queue)
    server.warmup(
        qt[: min(8, qt.shape[0])],
        qw[: min(8, qw.shape[0])],
        batch_sizes=args.queue_shapes,
    )
    server.reset_stats()
    rng = np.random.default_rng(args.seed)
    n = args.queries
    gaps = rng.exponential(1.0 / args.arrival_qps, size=n)
    # the schedule starts where warm-up left the clock: a HybridClock has
    # accrued the warm-up's wall time, and a schedule from 0 would admit
    # every request at once
    arrivals = clock.now() + np.cumsum(gaps)
    order = rng.integers(0, qt.shape[0], size=n)
    completions = replay_arrivals(
        queue,
        arrivals.tolist(),
        [qt[i] for i in order],
        [qw[i] for i in order],
        [args.request_deadline_ms] * n,
    )
    waits = summarize_latencies([c.wait_ms for c in completions])
    by_rid = sorted(completions, key=lambda c: c.rid)
    ids = np.stack([c.doc_ids for c in by_rid])
    qrels = np.asarray(corpus.qrels)[order]
    flush_counts: dict = {}
    for f in queue.flush_log:
        key = f"b{f.bucket}xB{f.batch_shape}"
        flush_counts[key] = flush_counts.get(key, 0) + 1
    report = {
        "model": args.model,
        "mode": "admission-queue",
        "requests": n,
        "completed": queue.n_completed,
        "deadline_policy_violations": queue.n_violations,
        "infeasible_on_arrival": queue.n_infeasible,
        "degraded_flushes": queue.n_degraded,
        "rr@10": round(mrr_at_k(ids, qrels, 10), 4),
        "queue_wait_ms": {k: round(v, 3) for k, v in waits.row().items()},
        "flushes": dict(sorted(flush_counts.items())),
        "flush_reasons": {
            r: sum(1 for f in queue.flush_log if f.reason == r)
            for r in ("full", "deadline", "drain")
        },
    }
    if args.eval_qrels:
        # effectiveness of what was ACTUALLY served, grouped by flush rho —
        # the live-traffic ledger of the degradation trade
        from repro_torch.metrics.ir_metrics import effectiveness_report

        groups: dict = {}
        for c in by_rid:
            groups.setdefault(c.rho, []).append(c)
        report["effectiveness_by_served_rho"] = [
            {
                "rho": rho,
                "n_queries": len(cs),
                **{
                    k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in effectiveness_report(
                        np.stack([c.doc_ids for c in cs]),
                        qrels[[c.rid for c in cs]],
                        recall_k=min(args.k, 100),
                    ).items()
                },
            }
            for rho, cs in sorted(groups.items(), key=lambda kv: (kv[0] is None, kv[0] or 0))
        ]
    if args.counters:
        report["counters"] = _export_counters(server, queue)
    print(json.dumps(report, indent=1))
    _close_counters_endpoint(args, endpoint)


def _mutation_schedule(rng, n_docs: int, n_terms: int, horizon_s: float, qps: float):
    """Seeded Poisson mutation stream over an evolving live-gid set.

    The gid bookkeeping here mirrors the handle's (adds take sequential gids;
    updates/deletes target currently-live gids only), so the schedule is
    always applicable and the replay never hits a dead-gid mutation.
    """
    from repro_torch.serving.lifecycle import MutationEvent

    alive = list(range(n_docs))
    next_gid = n_docs
    events = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / qps))
        if t >= horizon_s:
            break
        op = str(rng.choice(["add", "update", "delete"], p=[0.5, 0.25, 0.25]))
        if not alive and op != "add":
            op = "add"
        if op == "delete":
            gid = alive.pop(int(rng.integers(len(alive))))
            events.append(MutationEvent(t_s=t, op="delete", gid=gid))
            continue
        n_term = int(rng.integers(2, 8))
        terms = rng.choice(n_terms, size=n_term, replace=False).astype(np.int64)
        weights = rng.uniform(0.2, 4.0, n_term)
        if op == "add":
            events.append(MutationEvent(t_s=t, op="add", terms=terms, weights=weights))
            alive.append(next_gid)
            next_gid += 1
        else:
            gid = int(alive[int(rng.integers(len(alive)))])
            events.append(
                MutationEvent(t_s=t, op="update", gid=gid, terms=terms, weights=weights)
            )
    return events


def _serve_churn(args, corpus, enc, cfg: ServingConfig, qt, qw, device) -> None:
    """Arrival + mutation replay over a generation-handled index.

    Runs the deterministic :func:`replay_with_churn` loop on a
    ``SimulatedClock``: queries and mutations interleave at their scheduled
    instants, threshold compaction folds main+delta−tombstones and hot-swaps
    the new generation between flushes, and the report carries the churn
    ledger next to the usual queue metrics.
    """
    from repro_torch.core.index_handle import IndexHandle
    from repro_torch.metrics.latency import SimulatedClock
    from repro_torch.serving.lifecycle import CompactionPolicy, Compactor, replay_with_churn

    clock = SimulatedClock()
    handle = IndexHandle.from_corpus(
        enc.doc_idx, enc.term_idx, enc.weights, corpus.n_docs, enc.n_terms, device=device
    )
    server = AnytimeServer(handle, cfg, clock=clock)
    queue = AdmissionQueue(
        server,
        batch_shapes=args.queue_shapes,
        clock=clock,
        safety_ms=args.queue_safety_ms,
        max_wait_s=args.queue_max_wait_s,
        degrade_rho=args.degrade_rho,
    )
    # endpoint up before the (slow) warmup so scrapers see the whole run
    endpoint = _maybe_counters_endpoint(args, server, queue)
    server.warmup(
        qt[: min(8, qt.shape[0])],
        qw[: min(8, qw.shape[0])],
        batch_sizes=args.queue_shapes,
    )
    server.reset_stats()
    rng = np.random.default_rng(args.seed)
    n = args.queries
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_qps, size=n))
    order = rng.integers(0, qt.shape[0], size=n)
    mutations = _mutation_schedule(
        np.random.default_rng(args.seed + 1), corpus.n_docs, enc.n_terms,
        float(arrivals[-1]), args.mutate_qps,
    )
    compactor = Compactor(
        queue, handle, CompactionPolicy(max_delta_docs=args.compact_delta_docs)
    )
    completions, mutation_log = replay_with_churn(
        queue,
        handle,
        arrivals.tolist(),
        [qt[i] for i in order],
        [qw[i] for i in order],
        [args.request_deadline_ms] * n,
        mutations,
        compactor=compactor,
    )
    waits = summarize_latencies([c.wait_ms for c in completions])
    by_rid = sorted(completions, key=lambda c: c.rid)
    ids = np.stack([c.doc_ids for c in by_rid])
    qrels = np.asarray(corpus.qrels)[order]
    gens = [f.generation for f in queue.flush_log] or [handle.generation]
    op_counts: dict = {}
    for m in mutation_log:
        op_counts[m["op"]] = op_counts.get(m["op"], 0) + 1
    report = {
        "model": args.model,
        "mode": "admission-queue+churn",
        "requests": n,
        "completed": queue.n_completed,
        "deadline_policy_violations": queue.n_violations,
        "rr@10": round(mrr_at_k(ids, qrels, 10), 4),
        "queue_wait_ms": {k: round(v, 3) for k, v in waits.row().items()},
        "mutations": {
            "total": len(mutation_log),
            **dict(sorted(op_counts.items())),
            "compactions": compactor.n_compactions,
            "final_generation": handle.generation,
            "flush_generation_span": [min(gens), max(gens)],
            "pending_delta_docs": handle.delta_docs,
            "tombstones": handle.tombstone_count,
        },
    }
    if args.counters:
        report["counters"] = _export_counters(server, queue)
    print(json.dumps(report, indent=1))
    _close_counters_endpoint(args, endpoint)


def _maybe_counters_endpoint(args, server, queue=None):
    """Start the localhost scrape endpoint when ``--counters-port`` is set.

    Each ``GET /metrics`` derives the counter families fresh from the live
    server/queue — the same scrape-time derivation ``--counters`` uses for
    the final report, so the endpoint adds nothing to the hot path.
    """
    if args.counters_port is None:
        return None
    import sys
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def render() -> str:
        return _scrape_registry(server, queue).render()

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *_args):  # keep stdout JSON-clean
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", args.counters_port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    sys.stderr.write(
        f"counters endpoint: http://127.0.0.1:{httpd.server_address[1]}/metrics\n"
    )
    return httpd


def _close_counters_endpoint(args, httpd) -> None:
    if httpd is None:
        return
    if args.counters_linger_s > 0:
        import time

        time.sleep(args.counters_linger_s)
    httpd.shutdown()
    httpd.server_close()


def _scrape_registry(server, queue=None):
    from repro_torch.serving.counters import CounterRegistry

    registry = CounterRegistry()
    if queue is not None:
        queue.export_counters(registry)
    server.export_counters(registry)
    return registry


def _export_counters(server, queue=None) -> dict:
    """Scrape the serving counter families once, post-run.

    Counters are *derived* at scrape time from the flush log and server
    tallies; the hot path carries no instrumentation. The Prometheus text
    exposition goes to stderr so the stdout JSON report stays parseable;
    a structured copy lands in the report for jq-style assertions.
    """
    import sys

    registry = _scrape_registry(server, queue)
    sys.stderr.write(registry.render())
    return registry.as_dict()


if __name__ == "__main__":
    main()
