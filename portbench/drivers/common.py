"""What both loops share: the server the traffic file describes, and the
benchmark's span around each of its batches."""
from __future__ import annotations

import time

from portbench.trace import span


def lq_buckets(traffic: dict, pool_max_lq: int) -> tuple:
    """The traffic's Lq bucket widths; ``"pool_max"`` is the pool's longest query."""
    return tuple(sorted({pool_max_lq if b == "pool_max" else int(b) for b in traffic["lq_buckets"]}))


def make_server(run, pool_max_lq: int):
    """An ``AnytimeServer`` over the run's index as the traffic file sets it."""
    from repro_torch.serving.scheduler import AnytimeServer, ServingConfig

    t = run.cell.traffic
    kw = dict(k=int(t["k"]), lq_buckets=lq_buckets(t, pool_max_lq), engine=t["engine"])
    if t["engine"] == "saat":
        kw.update(rho_ladder=(int(t["rho"]),), fused_topk=bool(t["fused_topk"]),
                  batch_size=max(t["batch_shapes"]))
    else:
        kw.update(batch_size=int(t["batch"]), daat_est_blocks=int(t["est_blocks"]),
                  daat_block_budget=int(t["block_budget"]), daat_exact=bool(t["exact"]),
                  daat_use_kernels=bool(t["use_kernels"]), daat_fused_chunk=bool(t["fused_chunk"]),
                  daat_trips_per_launch=int(t["trips_per_launch"]))
    server = AnytimeServer(run.index, ServingConfig(**kw))
    if t["engine"] == "saat":
        # The server always appends the exact level to its ladder and, with
        # no deadline of its own, serves the top one; the cell's guarantee
        # is the one budget the traffic states, so the ladder is that level.
        server.rho_ladder = (min(int(t["rho"]), run.index.n_postings),)
    return server


def timed_search_batch(run, server) -> list:
    """Wrap ``server.search_batch`` in the benchmark's span: each call's host
    clock interval (it ends in the server's device sync) and its postings
    processed (a tensor of its own; the result's other fields can be views of
    the call's larger temporaries, which holding them would keep alive) are
    appended to the returned list."""
    calls: list = []
    inner = server.search_batch
    on = run.trace

    def search_batch(q_terms, q_weights, rho=None):
        with span("pb.search_batch", on):
            t0 = time.perf_counter()
            res = inner(q_terms, q_weights, rho=rho)
            calls.append((t0, time.perf_counter(), res.postings_processed))
        return res

    server.search_batch = search_batch
    return calls
