"""The per-layer metrics that read the program's own spans, on the CPU:
small traced runs of the three cells through ``execute``.

* each span metric prints in the cells its entry lists and nowhere else,
  and an untraced run prints none;
* the server's issue and sync p95s split its ``server.search_batch`` span,
  and the planner's and B1's issue lie inside it;
* every batch's phase-2 host reads are ``ceil(max chunks / trips a
  launch) + 1``, the chunks from the batch's ``WorkStats``.
"""
import math

import pytest
import torch

from portbench.harness import Run, load_benchmark
from portbench.program_spans import host_ms, phase2
from portbench.run import execute
from portbench.stats import percentile

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 2**31 + 5
SMALL = {"n_docs": 2000, "n_queries": 160}
# several phase-2 launches a batch: two blocks a trip, three trips a launch
DAAT = {"batch": 8, "sample": 4096, "probe_batches": 1, "est_blocks": 2, "block_budget": 2,
        "trips_per_launch": 3}
CELLS = {
    "spladev2-saat-open": ({}, {"rate_qps": 1500, "sample": 4096, "rho": 3000}, 0.6),
    "bm25-daat-batch": ({}, DAAT, 0.6),
    # SPLADEv2's long documents and queries make the plain scorer slow on
    # the CPU: five blocks, a block a trip, fewer queries, one Lq bucket
    # (two warm-up batches)
    "spladev2-daat-batch": ({"n_docs": 640, "n_queries": 40},
                            dict(DAAT, batch=4, lq_buckets=["pool_max"], block_budget=1,
                                 trips_per_launch=2), 0.4),
}
NEW = ("flush_ms_p95", "issue_ms_p95.saat", "sync_wait_ms_p95.saat",
       "planner_issue_ms_mean.saat", "b1_issue_ms_mean.saat", "phase2_issue_ms_mean.daat",
       "phase2_read_ms_mean.daat", "phase2_reads_mean.daat")
SPAN_METRICS = {m["name"]: m["workloads"] for m in load_benchmark()["per_layer"] if m["name"] in NEW}


def _run(cell, trace):
    """The result line and the run it came from."""
    config, traffic, seconds = CELLS[cell]
    runs = []
    inner = Run.read_metrics

    def keep(self, entries):
        runs.append(self)
        return inner(self, entries)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Run, "read_metrics", keep)
        r = execute(cell, SEED, seconds, trace, CPU,
                    overrides={"config": {**SMALL, **config}, "traffic": traffic})
    assert r["correct"] is True, r["checks"]
    return r, runs[-1]


@pytest.fixture(scope="module")
def traced():
    return {cell: _run(cell, True) for cell in CELLS}


def test_every_span_metric_has_its_entry():
    assert set(SPAN_METRICS) == set(NEW)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_span_metric_prints_in_its_cells_alone(traced, cell):
    r, _ = traced[cell]
    printed = {n for n in r["metrics"] if n in SPAN_METRICS}
    assert printed == {n for n, cells in SPAN_METRICS.items() if cell in cells}
    assert all(r["metrics"][n]["value"] >= 0 for n in printed)
    if cell == "bm25-daat-batch":  # the untraced line reads no span
        untraced, _ = _run(cell, False)
        assert not set(untraced["metrics"]) & set(SPAN_METRICS)


def test_issue_and_sync_split_the_servers_span(traced):
    r, run = traced["spladev2-saat-open"]
    issue = r["metrics"]["issue_ms_p95.saat"]["value"]
    sync = r["metrics"]["sync_wait_ms_p95.saat"]["value"]
    batch_p95 = percentile(host_ms(run, "server.search_batch"), 95)
    assert 0 <= issue + sync <= batch_p95 + 0.5
    # and the span lies inside the benchmark's own around the same call
    assert batch_p95 <= r["metrics"]["service_ms_p95.saat"]["value"]
    # the planner's and B1's issue lie inside the server's, flush by flush
    planner = r["metrics"]["planner_issue_ms_mean.saat"]["value"]
    b1 = r["metrics"]["b1_issue_ms_mean.saat"]["value"]
    batch_mean = host_ms(run, "server.search_batch").mean()
    assert 0 < planner + b1 <= batch_mean


@pytest.mark.parametrize("cell", ["bm25-daat-batch", "spladev2-daat-batch"])
def test_each_batch_reads_once_a_launch_and_once_more(traced, cell):
    r, run = traced[cell]
    trips = int(CELLS[cell][1]["trips_per_launch"])
    _, _, reads = phase2(run)
    chunks = run.records["trips_max"]  # each batch's largest WorkStats.chunks, in order
    assert len(reads) == len(chunks) > 0
    assert list(reads) == [math.ceil(c / trips) + 1 for c in chunks]
    assert max(reads) > 2  # the loop ran more than one launch somewhere
    assert r["metrics"]["phase2_reads_mean.daat"]["value"] == pytest.approx(reads.mean())
