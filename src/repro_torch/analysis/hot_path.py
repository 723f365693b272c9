"""Hot-path lint: what a served dispatch reads on the host, its dtypes, and
one program per executable key.

The port of ``repro.analysis.hot_path``. The reference traces its serving
executables to jaxprs and allows them no host round trip at all. The port
runs eagerly: a dispatch is the list of ops it records
(:func:`repro_torch.analysis.op_trace.record`), and its engines make a few
host reads by design. The lint holds each route to its **host-read
budget** (:class:`HostReadBudget`): the reads it may make, where (file and
function) and how many, as a formula of the dispatch's own work:

  * SAAT (``core/saat.py:246``, ``saat_search``): one read a search at an
    exact budget (the gather stops at the batch's largest candidate
    total), none otherwise; a handle-backed server's delta is always
    searched exactly, so it adds one. The fused route (``fused_topk``)
    bounds each row on the device and reads nothing;
  * DAAT exact (``core/daat.py:488``, ``daat_search_batched``): one read a
    pass of the phase-2 loop (its ``act.any()`` test) and the last test;
    a pass is a trip in the plain, split and fused modes and a launch of
    ``trips_per_launch`` trips in the multi-trip mode. Approximate DAAT
    runs one gated trip and reads nothing.

(``core/daat.py:281`` is the per-query oracle ``daat_search_vmap``'s loop,
one read a trip; no server dispatches it.) A read beyond the budget fails
the check; so does a read at a site the budget does not name. On a card
the CUDA sync debug mode counts the synchronizing calls of the same call,
and the two counts must agree.

The other checks: **dtype** (a boundary input that is not i32/f32 is
another dispatch; any f64/complex128 op is an x64 leak), **dense_blockmax**
(kernel-mode DAAT phase 0 never builds the ``[B, Lq, n_blocks]`` block-max
rows; kernel events are opaque), **repeat** (after a warm-up call, two
calls on the same inputs record the same trace) and **executable_key**
(``AnytimeServer.executable_key``, and a sharded step's ``.statics``, map
one to one onto programs, compared by trace fingerprint on one
deterministic input per (Lq bucket, B) shared by every config). A DAAT
trace's length follows its trips, which follow the data: the bijection
holds on that shared input, not across inputs.

Run with ``python -m repro_torch.analysis.check --serving --device cpu``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.kernel_contracts import Violation
from repro_torch.analysis.op_trace import OpTrace, find_kernel_calls, record

# Where the engines read on the host (path, function): see the module
# docstring for the lines and the counts.
SAAT_READ_SITE = ("repro_torch/core/saat.py", "saat_search")
DAAT_READ_SITE = ("repro_torch/core/daat.py", "daat_search_batched")


@dataclasses.dataclass(frozen=True)
class HostReadBudget:
    """The host reads a route's dispatch may make: at ``sites`` (``(path,
    function)`` pairs), at most ``allowed(trace)`` of them, the count the
    recorded call's own work gives; ``rule`` states the formula."""

    rule: str
    sites: tuple = ()
    allowed: Callable[[OpTrace], int] = lambda trace: 0


NO_READS = HostReadBudget("no host read")


def saat_budget(exact_searches: int) -> HostReadBudget:
    """``exact_searches`` reads: one a ``saat_search`` at an exact budget."""
    return HostReadBudget(
        f"{exact_searches}: one a saat_search at an exact budget (core/saat.py:246)",
        (SAAT_READ_SITE,), lambda trace: exact_searches)


def _main_result(result):
    """The main segment's engine result of a handle-backed dispatch."""
    return getattr(result, "main", result)


def daat_budget(exact: bool, trips_per_launch: int = 1, searches: int = 1) -> HostReadBudget:
    """Exact DAAT: a read a pass of the phase-2 loop and the last test
    (core/daat.py:488), a pass a trip, or a launch of ``trips_per_launch``
    trips; approximate DAAT: none. ``searches`` > 1 (a sharded step's
    shards) bounds the passes by each shard's ``max_chunks``."""
    if not exact:
        return HostReadBudget("0: approximate DAAT runs one gated trip and tests nothing")
    if trips_per_launch > 1:
        rule = "chunk_step_multi launches + 1 (core/daat.py:488)"

        def allowed(trace):
            return len(find_kernel_calls(trace, "chunk_step_multi")) + 1
    else:
        rule = "max(chunks) + 1: a read a trip and the last test (core/daat.py:488)"

        def allowed(trace):
            chunks = _main_result(trace.result).chunks
            return (int(chunks.max()) if chunks.numel() else 0) + 1
    return HostReadBudget(rule, (DAAT_READ_SITE,), allowed)


def server_budget(server, rho: Optional[int] = None) -> HostReadBudget:
    """The budget of an :class:`AnytimeServer`'s dispatch at ``rho``."""
    cfg = server.cfg
    if cfg.engine == "daat":
        return daat_budget(cfg.daat_exact, cfg.daat_trips_per_launch)
    if cfg.fused_topk:
        return saat_budget(0)  # each row is bounded on the device
    rho = server.rho_ladder[-1] if rho is None else rho
    main = server.handle.main if server.handle is not None else server.index
    n = int(rho >= main.n_postings)
    if server.handle is not None and server.handle.delta is not None:
        n += 1  # the delta is searched at its exact rho
    return saat_budget(n)


def sharded_budget(statics: dict, index_stack) -> HostReadBudget:
    """The budget of a sharded or pod step run in process (every rank's
    shards searched here): SAAT, a read a shard when ``rho_per_shard``
    reaches a shard's posting count (none on the fused route); DAAT, at
    most ``max_chunks + 1`` a shard (a trip a pass; ``trips_per_launch``
    trips a pass)."""
    n_shards = int(index_stack.doc_ids.shape[0])
    if statics["engine"] != "daat":
        exact = statics["rho_per_shard"] >= index_stack.doc_ids.shape[1]
        return saat_budget(n_shards * int(exact and not statics["fused_topk"]))
    if not statics["daat_exact"]:
        return daat_budget(False)
    n_blocks = int(index_stack.doc_terms.shape[1]) // int(index_stack.block_size)
    passes = -(-n_blocks // min(statics["daat_block_budget"], n_blocks))
    passes = -(-passes // statics["daat_trips_per_launch"])
    return HostReadBudget(
        f"at most {n_shards} x ({passes} + 1): each shard's loop (core/daat.py:488)",
        (DAAT_READ_SITE,), lambda trace: n_shards * (passes + 1))


def _at(site: Optional[str], sites) -> bool:
    if site is None:
        return False
    path, _, rest = site.partition(":")
    func = rest.partition(" in ")[2]
    return any(path == p and func == f for p, f in sites)


def check_host_sync(trace: OpTrace, label: str = "<call>", case: str = "trace",
                    budget: Optional[HostReadBudget] = None) -> list:
    """Hold a recorded dispatch's host reads to its route's budget (none
    without one). On a card, the recorder's count must equal the CUDA sync
    debug mode's."""
    budget = NO_READS if budget is None else budget
    reads = trace.reads()
    named = [op for op in reads if _at(op.site, budget.sites)]
    out = [Violation(
        label, case, "host_sync",
        f"'{op.name}' reads a device value on the host ({op.read}) at {op.site}: a read the "
        f"route's budget ({budget.rule}) does not name; move it off the served path or into "
        "the host-side wrapper") for op in reads if op not in named]
    allowed = budget.allowed(trace)
    if len(named) > allowed:
        out.append(Violation(
            label, case, "host_sync",
            f"{len(named)} host reads at {sorted({op.site for op in named})}, beyond the "
            f"route's budget of {allowed} ({budget.rule})"))
    if trace.sync_warnings is not None and trace.sync_warnings != len(reads):
        out.append(Violation(
            label, case, "host_sync",
            f"the recorder counted {len(reads)} host reads, the CUDA sync debug mode "
            f"{trace.sync_warnings} synchronizing calls: a host round trip the recorder does not "
            "see (a .tolist(), .numpy() or blocking copy?)"))
    return out


_WIDE = ("float64", "complex128")


def check_dtype_discipline(trace: OpTrace, label: str = "<call>", case: str = "trace") -> list:
    """Boundary inputs are i32/f32 (another dtype is another dispatch, the
    eager counterpart of a weak type), and no op touches f64/complex128."""
    out = []
    for i, (dtype, shape, _) in enumerate(trace.arg_types):
        if dtype not in ("int32", "float32"):
            out.append(Violation(
                label, case, "dtype",
                f"input {i} is {dtype}{list(shape)}: the served path is an i32/f32 contract, and "
                "another dtype dispatches other kernels; canonicalize before dispatch "
                "(AnytimeServer._bucketize does)"))
    seen = set()
    for op in trace.ops:
        for dtype, _, _ in op.inputs + op.outputs:
            if dtype in _WIDE and (op.name, dtype) not in seen:
                seen.add((op.name, dtype))
                out.append(Violation(
                    label, case, "dtype",
                    f"'{op.name}' touches {dtype}: an x64 leak on the hot path, which is an "
                    "i32/f32 contract"))
    return out


def check_no_densified_blockmax(trace: OpTrace, dense_shape: Sequence[int],
                                label: str = "<call>", case: str = "trace") -> list:
    """Flag the densified ``[B, Lq, n_blocks]`` block-max intermediate.

    Kernel-mode DAAT phase 0 walks the CSR block-max lists directly
    (``block_prune_csr``): the per-(query, slot) dense matrix, ``Lq`` times
    the lists it expands from, must never be built. Any op of that exact
    shape in the recorded search means the densify path crept back in.
    Kernel events are opaque: what a kernel's plain version builds on the
    CPU is not the card's."""
    shape = tuple(int(d) for d in dense_shape)
    out = []
    for op in trace.ops:
        if op.name.startswith("kernel:"):
            continue
        if any(s == shape for _, s, _ in op.inputs + op.outputs):
            out.append(Violation(
                label, case, "dense_blockmax",
                f"'{op.name}' touches a tensor of shape {shape}: the densified [B, Lq, n_blocks] "
                "block-max rows are back in kernel-mode phase 0; the CSR prune kernel must read "
                "base/cnt windows off the index's lists, not dense rows"))
    return out


def fingerprint(trace: OpTrace) -> str:
    """Identity of a recorded program (the executable-key invariant)."""
    return hashlib.sha1(trace.text().encode()).hexdigest()


def lint_route(fn: Callable, args: Sequence, label: str, case: str,
               budget: Optional[HostReadBudget] = None) -> tuple[list, Optional[OpTrace]]:
    """Call ``fn(*args)`` once to warm up, record it twice, and run every
    check on the first record. -> (violations, trace or None)."""
    try:
        fn(*args)
        first = record(fn, *args)
        second = record(fn, *args)
    except Exception as e:  # noqa: BLE001 - a call that fails is the finding
        return [Violation(label, case, "trace", f"the served call failed: {e!r}")], None
    out = check_host_sync(first, label, case, budget) + check_dtype_discipline(first, label, case)
    if fingerprint(second) != fingerprint(first):
        out.append(Violation(
            label, case, "repeat",
            "two calls on the same inputs recorded different programs; a dispatch that is not "
            "repeatable cannot be warmed up or keyed"))
    return out, first


def lint_trace(fn: Callable, args: Sequence, label: str, case: str,
               budget: Optional[HostReadBudget] = None,
               reads: Optional[list] = None) -> tuple[list, Optional[str]]:
    """:func:`lint_route`, returning the program's fingerprint. -> (violations, fp).

    ``reads``: a list to which ``(case, host reads, budget, sync debug
    count or None)`` of the call is appended."""
    out, trace = lint_route(fn, args, label, case, budget)
    if trace is None:
        return out, None
    if reads is not None:
        allowed = (budget or NO_READS).allowed(trace)
        reads.append((case, len(trace.reads()), allowed, trace.sync_warnings))
    return out, fingerprint(trace)


def reads_summary(reads: list) -> str:
    """``{"reads/budget[/syncs]": dispatches}`` of a lint's ``reads``."""
    counts: dict = {}
    for _, n, allowed, syncs in reads:
        key = f"{n}/{allowed}" + ("" if syncs is None else f"/{syncs}")
        counts[key] = counts.get(key, 0) + 1
    return ", ".join(f"{k}: {v}" for k, v in sorted(counts.items()))


def query_batch(batch: int, lq: int, n_terms: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The deterministic i32/f32 ``[batch, lq]`` batch every config is
    linted on at that shape; its last slot is a pad slot (weight 0)."""
    rng = np.random.default_rng(1009 * batch + lq)
    qt = rng.integers(0, n_terms, (batch, lq)).astype(np.int32)
    qw = rng.uniform(0.1, 2.0, (batch, lq)).astype(np.float32)
    if lq > 1:
        qw[:, -1] = 0.0
    return (torch.as_tensor(qt, device=device), torch.as_tensor(qw, device=device))


def _key_check(reg: dict, key, fp: str, name: str, label: str, case: str) -> list:
    """The key-to-program bijection, both ways, over one registry."""
    by_key = reg.setdefault("by_key", {})
    by_fp = reg.setdefault("by_fp", {})
    out = []
    if key in by_key and by_key[key] != fp:
        out.append(Violation(
            label, case, "executable_key",
            f"executable key {key} names two different programs; equal keys must dispatch one "
            "program"))
    elif key not in by_key and fp in by_fp:
        out.append(Violation(
            label, case, "executable_key",
            f"executable keys {key} and {by_fp[fp][0]} ({by_fp[fp][1]}) name the SAME program: "
            "the key splits on a config the dispatch ignores, so the cost model learns two "
            "names for one program"))
    by_key[key] = fp
    by_fp.setdefault(fp, (key, name))
    return out


# --------------------------------------------------------------------------
# server lint: the AnytimeServer dispatch grid
# --------------------------------------------------------------------------


def lint_server(
    server,
    *,
    batch_sizes: Sequence[int] = (2, 4),
    rhos: Optional[Sequence[Optional[int]]] = None,
    label: Optional[str] = None,
    key_registry: Optional[dict] = None,
    reads: Optional[list] = None,
) -> list:
    """Lint every dispatch an :class:`AnytimeServer` can make.

    Walks the (rho-or-engine-config) x (Lq bucket) x (B) grid that
    ``warmup`` covers and the admission queue flushes into, recording
    ``server.engine_fn`` at each point on :func:`query_batch`'s input, and
    holds each to :func:`server_budget`. On top of the per-call checks it
    asserts the executable-key invariant both ways: equal keys record equal
    programs, distinct keys distinct ones. Pass one ``key_registry`` across
    calls to extend the bijection over server states that never coexist,
    such as a handle-backed server before and after a hot-swap compaction.
    ``reads`` collects each dispatch's host reads (:func:`lint_trace`).
    """
    cfg = server.cfg
    if label is None:
        label = f"server:{cfg.engine}"
    if rhos is None:
        # every ladder level: deadline degradation may flush any of them
        rhos = [None] if cfg.engine == "daat" else list(server.rho_ladder)
    buckets = list(server.lq_buckets) if server.lq_buckets is not None else [8]
    reg = key_registry if key_registry is not None else {}
    out: list = []
    for bucket in buckets:
        for B in batch_sizes:
            args = query_batch(B, bucket, server.index.n_terms, server.device)
            for rho in dict.fromkeys(rhos):
                case = f"lq{bucket}_b{B}" + ("" if rho is None else f"_rho{rho}")
                vs, fp = lint_trace(server.engine_fn(rho), args, label, case,
                                    server_budget(server, rho), reads)
                out.extend(vs)
                if fp is not None:
                    key = server.executable_key(bucket, B, rho)
                    out.extend(_key_check(reg, key, fp, f"{label}:{case}", label, case))
    return out


# --------------------------------------------------------------------------
# sharded serve lint: the step behind make_bucketed_serve_step
# --------------------------------------------------------------------------


def lint_sharded_serve(
    serve,
    index_stack,
    *,
    batch_sizes: Sequence[int] = (2,),
    buckets: Optional[Sequence[int]] = None,
    label: str = "sharded",
    key_registry: Optional[dict] = None,
    live_stack=None,
    reads: Optional[list] = None,
) -> list:
    """Lint a (possibly bucketed) sharded or pod serve step at every bucket
    width.

    ``make_bucketed_serve_step``'s wrapper buckets on the host with numpy;
    its ``.inner`` is the step it dispatches, recorded here at each of its
    ``.buckets`` widths and held to :func:`sharded_budget`. The step's
    ``.statics`` name its program as ``executable_key`` does, so (statics,
    bucket, B) keys must map one to one onto programs; pass one
    ``key_registry`` across calls so that two steps whose statics differ
    (a pod mesh and a single-host one at equal engine config) never name
    one program. A ``live_masked`` step takes its ``live_stack``.
    ``reads`` collects each dispatch's host reads (:func:`lint_trace`).
    """
    inner = getattr(serve, "inner", serve)
    if buckets is None:
        buckets = getattr(serve, "buckets", None)
        if buckets is None:
            raise ValueError(
                "serve fn has no .buckets tag and no explicit buckets were given; pass "
                "buckets=(...) matching the widths it will serve"
            )
    statics = getattr(serve, "statics", None)
    statics_key = tuple(sorted(statics.items())) if isinstance(statics, dict) else None
    budget = sharded_budget(statics, index_stack) if isinstance(statics, dict) else None
    reg = key_registry if key_registry is not None else {}
    out: list = []
    for bucket in buckets:
        for B in batch_sizes:
            case = f"lq{bucket}_b{B}"
            if live_stack is not None:
                def fn(qt, qw):
                    return inner(index_stack, qt, qw, live_stack=live_stack)
            else:
                def fn(qt, qw):
                    return inner(index_stack, qt, qw)
            args = query_batch(B, bucket, index_stack.n_terms, index_stack.device)
            vs, fp = lint_trace(fn, args, label, case, budget, reads)
            out.extend(vs)
            if fp is not None and statics_key is not None:
                key = statics_key + (int(bucket), int(B))
                out.extend(_key_check(reg, key, fp, f"{label}:{case}", label, case))
    return out
