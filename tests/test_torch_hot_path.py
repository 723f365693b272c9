"""The port's serving hot-path lint (``repro_torch.analysis.hot_path`` and
``check``) against the reference's, on the CPU.

* ``serving_config_matrix`` equals the reference's field by field after the
  name mapping ("jnp" -> "scatter", "pallas" -> "kernel"), and the
  partition of the server grid (config x Lq bucket x B x rho level) into
  executable keys is the reference's: two grid points share a port key
  exactly when they share a reference key;
* ``lint_server`` is clean on each of the eight configs, each route held
  to its host-read budget (SAAT: one read at the exact level; DAAT: a read
  a pass of the phase-2 loop and the last test), and the reads are where
  the budget says; the handle-backed servers before and after a compaction
  in one key registry; the sharded step at (1, 1) and the pod step at
  (2, 2); kernel-mode DAAT phase 0;
* each failure class is caught, with its ``[label / case / check]``
  message, and the matching clean call is clean: ``.item()`` in a served
  function beyond its budget, a read at a site the budget does not name, an
  f64 op, an i64 boundary input, a ``[B, Lq, NB]`` intermediate (flagged in
  both packages for the same stand-in shapes), a program that changes from
  call to call, two keys for one program;
* the CLI: ``--list``, ``--contract block_prune --device cpu`` and ``--all
  --device cpu`` exit 0 in process, and without ``--device`` it raises when
  there is no GPU.
"""
from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.check import _probe_index as ref_probe_index
from repro.analysis.check import serving_config_matrix as ref_config_matrix
from repro.analysis.hot_path import check_no_densified_blockmax as ref_check_dense
from repro.serving.scheduler import AnytimeServer as RefServer
from repro_torch.analysis import op_trace
from repro_torch.analysis.check import (
    _probe_index,
    config_label,
    main as check_main,
    run_daat_phase0_checks,
    serving_config_matrix,
)
from repro_torch.analysis.hot_path import (
    HostReadBudget,
    check_dtype_discipline,
    check_host_sync,
    check_no_densified_blockmax,
    lint_route,
    lint_server,
    lint_trace,
    query_batch,
    saat_budget,
)
from repro_torch.serving.scheduler import AnytimeServer, ServingConfig

pytestmark = pytest.mark.torch_port

NAMES = {"jnp": "scatter", "pallas": "kernel", "sort": "sort"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def probe_index():
    return _probe_index()


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


def test_config_matrix_is_the_references():
    ref, port = ref_config_matrix(), serving_config_matrix()
    assert len(ref) == len(port) == 8
    for r, p in zip(ref, port):
        for f in dataclasses.fields(r):
            want = getattr(r, f.name)
            if f.name == "scatter_impl":
                want = NAMES[want]
            assert getattr(p, f.name) == want, f.name


def _grid_points(server, engine):
    rhos = [None] if engine == "daat" else list(range(len(server.rho_ladder)))
    return [(b, B, r) for b in server.lq_buckets for B in (2, 4) for r in rhos]


def test_executable_key_partition_is_the_references(probe_index):
    """Grid points share a key in the port exactly when they share one in
    the reference (rho levels matched by their place on the ladder)."""
    ref_index = ref_probe_index()
    ref_keys, port_keys = [], []
    for i, (rc, pc) in enumerate(zip(ref_config_matrix(), serving_config_matrix())):
        rs, ps = RefServer(ref_index, rc), AnytimeServer(probe_index, pc)
        assert rs.rho_ladder == ps.rho_ladder
        for b, B, r in _grid_points(ps, pc.engine):
            rho = None if r is None else ps.rho_ladder[r]
            ref_keys.append(rs.executable_key(b, B, rho))
            port_keys.append(ps.executable_key(b, B, rho))
    for a, b in itertools.combinations(range(len(ref_keys)), 2):
        assert (ref_keys[a] == ref_keys[b]) == (port_keys[a] == port_keys[b]), (a, b)


@pytest.mark.parametrize("B,lq,nb", [(2, 6, 7), (3, 5, 11)])
def test_densified_blockmax_flagged_in_both_packages(B, lq, nb):
    rng = np.random.default_rng(B * lq * nb)
    qw, rows = rng.random((B, lq), np.float32), rng.random((B, lq, nb), np.float32)
    other = rng.random((B, nb), np.float32)
    ref_dense = jax.make_jaxpr(lambda q, r: jnp.einsum("ql,qlb->qb", q, r))(qw, rows)
    ref_clean = jax.make_jaxpr(lambda q, o: q.sum(-1)[:, None] * o)(qw, other)
    port_dense = op_trace.record(lambda q, r: torch.einsum("ql,qlb->qb", q, r),
                                 torch.as_tensor(qw), torch.as_tensor(rows))
    port_clean = op_trace.record(lambda q, o: q.sum(-1)[:, None] * o,
                                 torch.as_tensor(qw), torch.as_tensor(other))
    shape = (B, lq, nb)
    assert bool(ref_check_dense(ref_dense, shape)) == bool(check_no_densified_blockmax(
        port_dense, shape)) is True
    assert ref_check_dense(ref_clean, shape) == check_no_densified_blockmax(port_clean, shape) == []
    v = check_no_densified_blockmax(port_dense, shape, "seeded", "dense")[0]
    assert str(v).startswith("[seeded / dense / dense_blockmax]") and "CSR" in str(v)


# --------------------------------------------------------------------------
# the real serving grid lints clean
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", serving_config_matrix(), ids=config_label)
def test_server_grid_lints_clean(probe_index, cfg):
    violations = lint_server(AnytimeServer(probe_index, cfg), batch_sizes=(2, 4))
    assert violations == [], "\n".join(str(v) for v in violations)


@pytest.mark.parametrize("cfg", [serving_config_matrix()[0], serving_config_matrix()[6],
                                 serving_config_matrix()[7]], ids=config_label)
def test_route_reads_are_where_and_as_many_as_the_budget_says(probe_index, cfg):
    server = AnytimeServer(probe_index, cfg)
    args = query_batch(4, 8, probe_index.n_terms, "cpu")
    if cfg.engine == "saat":
        for rho, want in ((server.rho_ladder[0], 0), (server.rho_ladder[-1], 1)):
            _, trace = lint_route(server.engine_fn(rho), args, "x", "y", saat_budget(want))
            assert [op.site.split(":")[0] for op in trace.reads()] == \
                ["repro_torch/core/saat.py"] * want
        return
    _, trace = lint_route(server.engine_fn(), args, "x", "y")
    reads = trace.reads()
    assert {op.site.rsplit(" in ", 1)[1] for op in reads} == {"daat_search_batched"}
    multi = op_trace.find_kernel_calls(trace, "chunk_step_multi")
    passes = len(multi) if cfg.daat_trips_per_launch > 1 else int(trace.result.chunks.max())
    assert len(reads) == passes + 1


def test_handle_generations_share_one_key_registry():
    from repro_torch.core.index_handle import IndexHandle

    rng = np.random.default_rng(3)
    handle = IndexHandle.from_corpus(
        rng.integers(0, 220, 1500), rng.integers(0, 40, 1500),
        rng.uniform(0.1, 5.0, 1500).astype(np.float32), 220, 40, block_size=32, device="cpu")
    for gid in (3, 11, 19):
        handle.delete(gid)
    handle.add(np.array([1, 4, 7]), np.array([1.0, 2.0, 0.5]))
    cfgs = (ServingConfig(engine="saat", k=5, rho_ladder=(200, 1000), lq_buckets=(4, 8),
                          scatter_impl="scatter"),
            ServingConfig(engine="daat", k=5, daat_est_blocks=4, daat_block_budget=4,
                          lq_buckets=(4, 8)))
    servers = [AnytimeServer(handle, c) for c in cfgs]
    reg: dict = {}
    before = [lint_server(s, batch_sizes=(2,), key_registry=reg) for s in servers]
    keys0 = set(reg["by_key"])
    handle.compact()
    for s in servers:
        s.swap_index()
    after = [lint_server(s, batch_sizes=(2,), key_registry=reg) for s in servers]
    assert before == after == [[], []]
    assert keys0 < set(reg["by_key"])  # the compacted generation named new programs


def test_sharded_and_pod_steps_lint_clean(capsys):
    from repro_torch.analysis.check import run_serving_checks

    assert run_serving_checks(batch_sizes=(2,)) == []
    out = capsys.readouterr().out
    assert "sharded+bucketed serve: 0 violations" in out and "pod2x2 serve: 0 violations" in out


@pytest.mark.parametrize("trips", [1, 3])
def test_sharded_daat_step_lints_clean_within_its_budget(trips):
    """A DAAT step at (1, 2): each shard's loop reads at most max_chunks + 1
    times (a pass a trip, or a launch of ``trips`` trips)."""
    from repro_torch.analysis.hot_path import lint_sharded_serve, sharded_budget
    from repro_torch.core.daat import max_blocks_per_term
    from repro_torch.core.saat import max_segments_per_term
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.serving.sharded import make_bucketed_serve_step, shard_corpus, stack_indexes

    rng = np.random.default_rng(5)
    shards, dps = shard_corpus(rng.integers(0, 256, 1200), rng.integers(0, 32, 1200),
                               rng.uniform(0.1, 5.0, 1200).astype(np.float32), 256, 32, 2,
                               block_size=32, device="cpu")
    stack = stack_indexes(shards)
    serve, _, _ = make_bucketed_serve_step(
        make_mesh((1, 2), ("data", "model"), device="cpu"), lq_buckets=(4,), n_terms=32, k=5,
        rho_per_shard=500, max_segs_per_term=max_segments_per_term(shards[0]),
        docs_per_shard=dps, engine="daat", daat_est_blocks=2, daat_block_budget=2,
        max_bm_per_term=max_blocks_per_term(shards[0]), daat_use_kernels=trips > 1,
        daat_fused_chunk=trips > 1, daat_trips_per_launch=trips)
    reads: list = []
    assert lint_sharded_serve(serve, stack, batch_sizes=(2,), reads=reads) == []
    (_, n, allowed, _), = reads
    assert 2 <= n <= allowed == sharded_budget(serve.statics, stack).allowed(None)


def test_daat_phase0_gate_is_clean():
    assert run_daat_phase0_checks() == []


# --------------------------------------------------------------------------
# seeded violations
# --------------------------------------------------------------------------

_ARGS = (torch.zeros((2, 4), dtype=torch.int32), torch.ones((2, 4)))


def test_item_in_a_served_fn_beyond_its_budget_is_caught():
    def served(qt, qw):
        theta = qw.sum().item()  # the classic accident
        return qw * theta

    violations, fp = lint_trace(served, _ARGS, "seeded", "item")
    assert fp is not None
    assert [v.check for v in violations] == ["host_sync"]
    assert str(violations[0]).startswith("[seeded / item / host_sync]")
    assert "test_torch_hot_path.py" in violations[0].message  # names the site
    # named in a budget of one, it is clean; in a budget of none it is one too many
    site = op_trace.record(served, *_ARGS).reads()[0].site
    here = (site.split(":")[0], "served")
    one = HostReadBudget("one", (here,), lambda trace: 1)
    assert lint_trace(served, _ARGS, "seeded", "item", one)[0] == []
    none = HostReadBudget("none", (here,), lambda trace: 0)
    assert [v.check for v in lint_trace(served, _ARGS, "seeded", "item", none)[0]] == ["host_sync"]


def test_data_dependent_shape_is_a_host_read():
    trace = op_trace.record(lambda qt, qw: qw[qw > 0.5].sum() + torch.nonzero(qt).shape[0], *_ARGS)
    assert [op.read for op in trace.reads()] == ["shape", "shape"]
    assert check_host_sync(trace)


def test_f64_op_is_caught():
    violations, _ = lint_trace(lambda qt, qw: (qw.double() * 2).float(), _ARGS, "seeded", "f64")
    assert violations and {v.check for v in violations} == {"dtype"}
    assert "float64" in str(violations[0])


def test_i64_boundary_input_is_caught():
    trace = op_trace.record(lambda qt, qw: qw[0, qt[0]], _ARGS[0].long(), _ARGS[1])
    violations = check_dtype_discipline(trace, "seeded", "i64")
    assert [v.check for v in violations] == ["dtype"] and "int64" in str(violations[0])
    assert check_dtype_discipline(op_trace.record(lambda qt, qw: qw[0, qt[0]], *_ARGS)) == []


def test_pure_hot_path_is_clean():
    violations, fp = lint_trace(lambda qt, qw: (qw * 2.0).sum(-1), _ARGS, "seeded", "pure")
    assert fp is not None and violations == []


def test_program_that_changes_between_calls_is_caught():
    calls = []

    def drifting(qt, qw):
        calls.append(1)
        return qw[:, : 1 + len(calls) % 3].sum()

    violations, _ = lint_trace(drifting, _ARGS, "seeded", "drift")
    assert [v.check for v in violations] == ["repeat"]


def test_two_keys_for_one_program_are_caught(probe_index):
    """A key that splits on a config the dispatch ignores: fused_topk
    ignores scatter_impl, so two fused servers that differ only there name
    one program by two keys."""
    base = dict(engine="saat", k=5, rho_ladder=(200,), lq_buckets=(4,), fused_topk=True)
    reg: dict = {}
    a = lint_server(AnytimeServer(probe_index, ServingConfig(scatter_impl="sort", **base)),
                    batch_sizes=(2,), key_registry=reg)
    b = lint_server(AnytimeServer(probe_index, ServingConfig(scatter_impl="scatter", **base)),
                    batch_sizes=(2,), key_registry=reg, label="other")
    assert a == [] and b and {v.check for v in b} == {"executable_key"}
    assert "SAME program" in str(b[0])


def test_executable_keys_distinguish_configs(probe_index):
    base = dict(k=5, rho_ladder=(200,), lq_buckets=(4,))
    s1 = AnytimeServer(probe_index, ServingConfig(engine="saat", **base))
    s2 = AnytimeServer(probe_index, ServingConfig(engine="saat", fused_topk=True, **base))
    s3 = AnytimeServer(probe_index, ServingConfig(engine="saat", **base))
    assert s1.executable_key(4, 2) != s2.executable_key(4, 2)  # flag forks
    assert s1.executable_key(4, 2) == s3.executable_key(4, 2)  # same config aliases
    assert s1.executable_key(4, 2) != s1.executable_key(8, 2)  # bucket forks
    assert s1.executable_key(4, 2) != s1.executable_key(4, 4)  # batch forks


def test_bucketize_canonicalizes_dtypes(probe_index):
    # i16/f16 caller input must not fork the dispatch: _bucketize hands the
    # engine i32/f32 whatever arrives
    server = AnytimeServer(
        probe_index, ServingConfig(engine="saat", k=5, rho_ladder=(200,), lq_buckets=(4,)))
    ct, cw, bucket = server._bucketize(np.zeros((2, 3), np.int16), np.zeros((2, 3), np.float16))
    assert ct.dtype == torch.int32 and cw.dtype == torch.float32
    assert bucket == 4


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_list(capsys):
    assert check_main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "chunk_step" in out and "expect_async_copy=True" in out
    assert "block_prune_csr" in out


def test_cli_single_contract(capsys):
    assert check_main(["--contract", "block_prune", "--device", "cpu"]) == 0
    assert "0 violations" in capsys.readouterr().out


def test_cli_all_on_the_cpu(capsys):
    assert check_main(["--all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all checks passed" in out and out.count("0 violations") >= 7 + 14 + 2


def test_cli_without_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_main(["--all"])
