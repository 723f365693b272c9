"""The port's span recorder (``repro_torch.metrics.spans``) on the CPU.

* off, a site keeps nothing and opens no profiler range;
* on (while ``torch.profiler`` records), the serving stack's spans nest
  with the right parents, a flush's spans carry its ``FlushRecord``'s
  index, and DAAT's phase-2 span counts its host reads: one a launch and
  one to end the loop;
* every kept span has a profiler range of its name, in the same order and
  nesting, as long as the kept span within 5% or 50 us;
* tracing on adds no host read: a SAAT and a DAAT dispatch read the same
  on and off (the fused SAAT route reads nothing), and every served route
  keeps its host-read budget.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import op_trace
from repro_torch.analysis.check import _probe_index, config_label, serving_config_matrix
from repro_torch.analysis.hot_path import lint_server, query_batch
from repro_torch.metrics import spans
from repro_torch.serving import AdmissionQueue, AnytimeServer, ServingConfig

pytestmark = pytest.mark.torch_port

SAAT = ServingConfig(engine="saat", k=5, rho_ladder=(10**9,), fused_topk=True, lq_buckets=(4, 8))
DAAT = ServingConfig(engine="daat", k=5, daat_est_blocks=2, daat_block_budget=1,
                     daat_use_kernels=True, daat_fused_chunk=True, daat_trips_per_launch=2,
                     lq_buckets=(4, 8))
ENGINE = {"saat": SAAT, "daat": DAAT}
# each span's parent, by name
PARENT = {
    "queue.flush": None,
    "server.search_batch": "queue.flush",
    "server.bucketize": "server.search_batch",
    "server.sync": "server.search_batch",
    "saat.plan": "server.search_batch",
    "saat.gather": "server.search_batch",
    "saat.tile_sort": "server.search_batch",
    "saat.b1": "server.search_batch",
    "daat.phase0": "server.search_batch",
    "daat.phase1": "server.search_batch",
    "daat.phase2": "server.search_batch",
}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.take()
    yield
    spans.take()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    return _probe_index()


def _traced():
    """Tracing on: a profiler recording on the CPU."""
    return profile(activities=[ProfilerActivity.CPU])


def _requests(index, n, seed=3):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        lq = int(rng.integers(2, 8))
        yield (rng.integers(0, index.n_terms, lq).astype(np.int32),
               rng.uniform(0.5, 2.0, lq).astype(np.float32))


def _serve(index, engine, n=11):
    """``n`` requests through a queue of flushes of 2 or 4: full flushes
    while they arrive, then the drain."""
    queue = AdmissionQueue(AnytimeServer(index, ENGINE[engine]), batch_shapes=(2, 4))
    for qt, qw in _requests(index, n):
        queue.submit(qt, qw)
    queue.drain()
    return queue


def test_off_keeps_nothing_and_opens_no_range(index, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a site did work while tracing was off")

    monkeypatch.setattr(spans, "_RANGE", refuse)
    monkeypatch.setattr(spans, "_Tally", refuse)
    assert spans.span("saat.gather", rho=5) is spans._OFF
    assert spans.tally("read") is spans._OFF
    for engine in ENGINE:
        assert len(_serve(index, engine).flush_log) > 1
    assert spans.take() == []


@pytest.mark.parametrize("engine", sorted(ENGINE))
def test_spans_nest_and_carry_their_flush(index, engine):
    with _traced():
        queue = _serve(index, engine)
    kept = spans.take()
    names = {s.name for s in kept}
    want = {n for n in PARENT if not n.startswith(("saat.", "daat.")) or n.startswith(engine)}
    want -= {"saat.gather", "saat.tile_sort"}  # the fused route reads the plan: no gather, no sort
    assert names == want
    assert not any(n.startswith("pb.") for n in names)  # the benchmark's own prefix
    flushes = [s for s in kept if s.name == "queue.flush"]
    assert [s.group for s in flushes] == list(range(len(queue.flush_log)))
    for s, rec in zip(flushes, queue.flush_log):
        assert s.attrs == {"bucket": rec.bucket, "shape": rec.batch_shape, "reason": rec.reason}
    assert {rec.reason for rec in queue.flush_log} == {"full", "drain"}
    for i, s in enumerate(kept):
        assert s.index == i and s.start_ns <= s.end_ns
        if PARENT[s.name] is None:
            assert s.parent == -1
            continue
        up = kept[s.parent]
        assert up.name == PARENT[s.name] and up.group == s.group
        assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    if engine == "daat":
        loops = [s for s in kept if s.name == "daat.phase2"]
        assert len(loops) == len(flushes)
        for s in loops:  # the host reads' time lies inside the loop's
            assert set(s.attrs) == {"trip_cap", "reads", "read_ns"} and s.attrs["trip_cap"] == 2
            assert s.attrs["reads"] >= 1 and 0 <= s.attrs["read_ns"] * 1e-6 <= s.host_ms


def test_a_root_without_a_flush_is_numbered_as_a_batch(index):
    server = AnytimeServer(index, DAAT)
    with _traced():
        chunks = [int(server.search_batch(qt[None], qw[None]).stats.chunks.max())
                  for qt, qw in _requests(index, 3)]
    kept = spans.take()
    roots = [s for s in kept if s.parent == -1]
    assert [(s.name, s.group) for s in roots] == [("server.search_batch", g) for g in range(3)]
    # a read before each launch of up to 2 trips, and one to end the loop
    loops = [s for s in kept if s.name == "daat.phase2"]
    assert [s.attrs["reads"] for s in loops] == [math.ceil(c / 2) + 1 for c in chunks]
    assert max(chunks) > 2


def _innermost(event, names):
    up = event.cpu_parent
    while up is not None and up.name not in names:
        up = up.cpu_parent
    return None if up is None else up.name


def test_ranges_under_the_profiler_match_the_kept_spans(index):
    with _traced() as prof:
        assert spans.span("queue.flush") is not spans._OFF
        for engine in ENGINE:
            _serve(index, engine, n=6)
    assert spans.span("queue.flush") is spans._OFF
    kept = spans.take()
    ranges = sorted((e for e in prof.events() if e.name in PARENT),
                    key=lambda e: e.time_range.start)
    assert len(kept) > 20
    assert [e.name for e in ranges] == [s.name for s in kept]
    for s, e in zip(kept, ranges):
        assert _innermost(e, PARENT) == (None if s.parent < 0 else kept[s.parent].name)
        range_us = e.time_range.elapsed_us()
        assert abs(s.host_ms * 1e3 - range_us) <= max(0.05 * range_us, 50.0), (s, range_us)


@pytest.mark.parametrize("engine", sorted(ENGINE))
def test_tracing_on_reads_the_same_as_off(index, engine):
    server = AnytimeServer(index, ENGINE[engine])
    fn = server.engine_fn()  # SAAT fused at its exact level: no read; DAAT: a read a pass
    args = query_batch(4, 8, index.n_terms, "cpu")

    def reads():
        return [(op.name, op.read, op.site) for op in op_trace.record(fn, *args).reads()]

    off = reads()
    assert (off == []) if engine == "saat" else (len(off) >= 1)
    with _traced():
        on = reads()
    assert on == off
    assert spans.take()


@pytest.mark.parametrize("cfg", serving_config_matrix(), ids=config_label)
def test_every_route_keeps_its_read_budget_with_tracing_on(index, cfg):
    with _traced():
        violations = lint_server(AnytimeServer(index, cfg), batch_sizes=(2, 4))
    assert violations == [], "\n".join(str(v) for v in violations)
    saat = {"saat.plan", "saat.b1"} if cfg.fused_topk else {"saat.plan", "saat.gather"}
    want = saat if cfg.engine == "saat" else {"daat.phase0", "daat.phase1", "daat.phase2"}
    assert {s.name for s in spans.take()} >= want

