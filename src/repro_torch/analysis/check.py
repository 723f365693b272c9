"""Static-analysis gate: ``python -m repro_torch.analysis.check --all``.

The port of ``repro.analysis.check``. Runs the two passes over everything
checked in:

  * **kernel contracts**: every ``repro_torch.kernels.*`` package's
    ``CONTRACT`` (shared memory, launch limits, coverage, async-copy
    discipline, no host read in the wrapper) across its shape grid; see
    :mod:`repro_torch.analysis.kernel_contracts`;
  * **serving hot paths**: the ``AnytimeServer`` dispatch grid for the
    engine and flag matrix, handle-backed servers across a compaction, the
    sharded step at (1, 1) and the pod step at (2, 2), on a tiny synthetic
    probe index, each route held to its host-read budget; and kernel-mode
    DAAT phase 0 never densifying the block-max lists; see
    :mod:`repro_torch.analysis.hot_path`.

``--device`` picks where the calls run: ``cuda`` (the default; it raises
without a GPU) or ``cpu``, where every kernel's plain version runs in its
place. Exit status: the number of violations (0 = clean, at most 255),
each printed as ``[contract / case / check] message``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.device import resolve_device


def _probe_index(seed: int = 0, n_docs: int = 220, n_terms: int = 40,
                 n_postings: int = 1500, block_size: int = 32, device="cpu"):
    """Tiny synthetic impact index: big enough to exercise every phase,
    small enough that building it dominates nothing."""
    from repro_torch.core import build_impact_index

    rng = np.random.default_rng(seed)
    return build_impact_index(
        rng.integers(0, n_docs, n_postings),
        rng.integers(0, n_terms, n_postings),
        rng.uniform(0.1, 5.0, n_postings).astype(np.float32),
        n_docs,
        n_terms,
        block_size=block_size,
        device=device,
    )


def serving_config_matrix(lq_buckets: tuple = (4, 8), k: int = 5):
    """Every engine/flag combination the serving layer can dispatch: the
    reference's eight, under the port's names (its ``scatter_impl`` "jnp"
    is the port's "scatter", plain ``index_add_``; "pallas" is "kernel",
    the ``impact_scatter`` CUDA kernel; "sort" is "sort").

    Each route's host-read budget (:func:`repro_torch.analysis.hot_path.
    server_budget`):

      * SAAT, the three unfused: 1 read at the exact level
        (``core/saat.py:246``, the gather's stop at the batch's largest
        candidate total), 0 at the others; fused: 0 at every level (the
        kernel bounds each row by its own total);
      * DAAT exact, all four (plain, split kernels, fused chunk step, 4
        trips a launch): ``passes + 1`` reads at ``core/daat.py:488``
        (``act.any()`` before each pass of the phase-2 loop and once more
        to end it), a pass a trip, or a launch of up to 4 trips.
    """
    from repro_torch.serving.scheduler import ServingConfig

    saat = dict(engine="saat", k=k, rho_ladder=(200, 1000), lq_buckets=lq_buckets)
    daat = dict(
        engine="daat", k=k, daat_est_blocks=4, daat_block_budget=4,
        lq_buckets=lq_buckets,
    )
    return (
        ServingConfig(scatter_impl="scatter", **saat),
        ServingConfig(scatter_impl="sort", **saat),
        ServingConfig(scatter_impl="kernel", **saat),
        ServingConfig(scatter_impl="sort", fused_topk=True, **saat),
        ServingConfig(**daat),
        ServingConfig(daat_use_kernels=True, **daat),
        ServingConfig(daat_use_kernels=True, daat_fused_chunk=True, **daat),
        ServingConfig(
            daat_use_kernels=True, daat_fused_chunk=True,
            daat_trips_per_launch=4, **daat,
        ),
    )


def config_label(cfg) -> str:
    return f"server:{cfg.engine}:scatter={cfg.scatter_impl}" + (
        ":fused_topk" if cfg.fused_topk else ""
    ) + (":kernels" if cfg.daat_use_kernels else "") + (
        ":fused_chunk" if cfg.daat_fused_chunk else ""
    ) + (
        f":trips{cfg.daat_trips_per_launch}" if cfg.daat_trips_per_launch > 1 else ""
    )


def run_daat_phase0_checks(device="cpu") -> list:
    """Assert kernel-mode phase 0 never densifies the block-max lists.

    Records ``daat_search_batched(use_kernels=True)`` on the probe index
    and scans the ops for any tensor of the densified ``[B, Lq, n_blocks]``
    shape, the intermediate the CSR prune kernel exists to remove."""
    from repro_torch.analysis.hot_path import check_no_densified_blockmax, query_batch
    from repro_torch.analysis.op_trace import record
    from repro_torch.core import daat_search_batched
    from repro_torch.core.daat import max_blocks_per_term

    index = _probe_index(device=device)
    mb = max_blocks_per_term(index)
    out = []
    for B, lq in ((2, 6), (4, 8)):
        qt, qw = query_batch(B, lq, index.n_terms, index.device)
        trace = record(
            lambda qt, qw: daat_search_batched(
                index, qt, qw, k=5, est_blocks=4, block_budget=4,
                max_bm_per_term=mb, exact=True, use_kernels=True,
            ), qt, qw)
        vs = check_no_densified_blockmax(
            trace, (B, lq, index.n_blocks), label="daat:kernels:phase0", case=f"B{B}_lq{lq}",
        )
        print(f"  daat kernel-mode phase 0 B={B} Lq={lq} "
              f"(no densified block-max): {len(vs)} violations")
        out.extend(vs)
    return out


def run_kernel_checks(names: Optional[Sequence[str]] = None, device="cpu") -> list:
    from repro_torch.analysis.kernel_contracts import all_contracts, check_contract

    contracts = all_contracts()
    if names:
        unknown = sorted(set(names) - set(contracts))
        if unknown:
            raise SystemExit(
                f"unknown contract(s) {unknown}; have {sorted(contracts)}"
            )
        contracts = {n: contracts[n] for n in names}
    out = []
    for name, contract in contracts.items():
        t0 = time.perf_counter()
        vs = check_contract(contract, device=device)
        print(f"  contract {name}: {len(contract.shape_grid)} cases, "
              f"{len(vs)} violations ({time.perf_counter() - t0:.2f} s)")
        out.extend(vs)
    return out


def run_serving_checks(batch_sizes: Sequence[int] = (2, 4), device="cpu") -> list:
    """Lint every served route; prints each route's violations and its host
    reads a dispatch, as ``reads/budget`` (``/syncs`` on a card: the CUDA
    sync debug mode's count) with the number of dispatches at each."""
    from repro_torch.analysis.hot_path import lint_server, lint_sharded_serve, reads_summary
    from repro_torch.core.index_handle import IndexHandle
    from repro_torch.core.saat import max_segments_per_term
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.serving.scheduler import AnytimeServer, ServingConfig
    from repro_torch.serving.sharded import (
        make_bucketed_serve_step, shard_corpus, stack_indexes,
    )

    index = _probe_index(device=device)
    out = []
    for cfg in serving_config_matrix():
        label = config_label(cfg)
        reads: list = []
        vs = lint_server(AnytimeServer(index, cfg), batch_sizes=batch_sizes, label=label,
                         reads=reads)
        print(f"  {label}: {len(vs)} violations; host reads {reads_summary(reads)}")
        out.extend(vs)

    # generation-extended matrix: one handle-backed server per engine, linted
    # in its churned generation-0 state (main + delta + tombstones) and again
    # after compact() + swap_index(), all into ONE key registry: the
    # delta-merging program before the swap and the delta-free one after
    # are different programs, so their keys must differ, while a key that
    # changed with the generation alone would name one program twice.
    hrng = np.random.default_rng(3)
    h_docs, h_terms, h_post = 220, 40, 1500
    handle = IndexHandle.from_corpus(
        hrng.integers(0, h_docs, h_post), hrng.integers(0, h_terms, h_post),
        hrng.uniform(0.1, 5.0, h_post).astype(np.float32),
        h_docs, h_terms, block_size=32, device=device,
    )
    for gid in (3, 11, 19):
        handle.delete(gid)
    handle.add(np.array([1, 4, 7]), np.array([1.0, 2.0, 0.5]))
    handle.update(5, np.array([2, 6]), np.array([1.5, 2.5]))
    gen_reg: dict = {}
    gen_cfgs = (
        ServingConfig(engine="saat", k=5, rho_ladder=(200, 1000),
                      lq_buckets=(4, 8), scatter_impl="scatter"),
        ServingConfig(engine="daat", k=5, daat_est_blocks=4,
                      daat_block_budget=4, lq_buckets=(4, 8)),
    )
    gen_servers = [AnytimeServer(handle, cfg) for cfg in gen_cfgs]
    for phase in ("gen0", "gen1"):
        for cfg, server in zip(gen_cfgs, gen_servers):
            label = f"server:handle:{cfg.engine}:{phase}"
            reads = []
            vs = lint_server(server, batch_sizes=batch_sizes, label=label,
                             key_registry=gen_reg, reads=reads)
            print(f"  {label}: {len(vs)} violations; host reads {reads_summary(reads)}")
            out.extend(vs)
        if phase == "gen0":
            handle.compact()
            for server in gen_servers:
                server.swap_index()

    # the sharded step at (1, 1), then the pod step at (2, 2) into the same
    # key registry: the pod statics must name another program than the
    # single-host step's. The in-process mesh plays every rank on this
    # device, so the (2, 2) pod runs on one card or the CPU.
    rng = np.random.default_rng(1)
    n_docs, n_terms, n_post = 256, 32, 1200
    shards, docs_per_shard = shard_corpus(
        rng.integers(0, n_docs, n_post), rng.integers(0, n_terms, n_post),
        rng.uniform(0.1, 5.0, n_post).astype(np.float32),
        n_docs, n_terms, 1, block_size=32, device=device,
    )
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    serve, _, _ = make_bucketed_serve_step(
        mesh, lq_buckets=(4, 8), n_terms=n_terms, k=5, rho_per_shard=500,
        max_segs_per_term=max_segments_per_term(shards[0]),
        docs_per_shard=docs_per_shard,
    )
    key_reg: dict = {}
    reads = []
    vs = lint_sharded_serve(
        serve, stack_indexes(shards), batch_sizes=(2,), key_registry=key_reg, reads=reads,
    )
    print(f"  sharded+bucketed serve: {len(vs)} violations; host reads {reads_summary(reads)}")
    out.extend(vs)

    pod_shape = (2, 2)
    pod_shards, pod_dps = shard_corpus(
        rng.integers(0, n_docs, n_post), rng.integers(0, n_terms, n_post),
        rng.uniform(0.1, 5.0, n_post).astype(np.float32),
        n_docs, n_terms, pod_shape[0] * pod_shape[1], block_size=32, device=device,
    )
    pod_mesh = make_mesh(pod_shape, ("pod", "model"), device=device)
    pod_serve, _, _ = make_bucketed_serve_step(
        pod_mesh, lq_buckets=(4, 8), n_terms=n_terms, k=5, rho_per_shard=500,
        max_segs_per_term=max_segments_per_term(pod_shards[0]),
        docs_per_shard=pod_dps, n_docs_total=n_docs,
    )
    reads = []
    vs = lint_sharded_serve(
        pod_serve, stack_indexes(pod_shards), batch_sizes=(2,),
        label=f"pod{pod_shape[0]}x{pod_shape[1]}", key_registry=key_reg, reads=reads,
    )
    print(f"  pod{pod_shape[0]}x{pod_shape[1]} serve: {len(vs)} violations; "
          f"host reads {reads_summary(reads)}")
    out.extend(vs)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--all", action="store_true",
                   help="run kernel contracts AND serving hot-path lint")
    p.add_argument("--kernels", action="store_true",
                   help="run the kernel contract checker only")
    p.add_argument("--serving", action="store_true",
                   help="run the serving hot-path lint only")
    p.add_argument("--contract", action="append", metavar="NAME",
                   help="restrict --kernels to the named contract(s)")
    p.add_argument("--list", action="store_true",
                   help="list registered contracts and exit")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    args = p.parse_args(argv)

    if args.list:
        from repro_torch.analysis.kernel_contracts import all_contracts

        for name, c in sorted(all_contracts().items()):
            cases = ", ".join(case.name for case in c.shape_grid)
            print(f"{name}: {c.description or '(no description)'}")
            print(f"  cases: {cases}")
            print(f"  smem limit: {c.smem_limit_bytes} B, "
                  f"expect_async_copy={c.expect_async_copy}, "
                  f"expect_no_host_read={c.expect_no_host_read}")
        return 0

    do_kernels = args.kernels or args.all or args.contract
    do_serving = args.serving or args.all
    if not (do_kernels or do_serving):
        p.error("pick one of --all / --kernels / --serving / --list")
    device = resolve_device(args.device)

    violations = []
    if do_kernels:
        print(f"kernel contracts ({device}):")
        violations += run_kernel_checks(args.contract, device)
    if do_serving:
        print(f"serving hot paths ({device}):")
        violations += run_serving_checks(device=device)
        violations += run_daat_phase0_checks(device)

    if violations:
        print(f"\n{len(violations)} violation(s):", file=sys.stderr)
        for v in violations:
            print(f"  {v}", file=sys.stderr)
    else:
        print("\nall checks passed")
    return min(len(violations), 255)


if __name__ == "__main__":
    sys.exit(main())
