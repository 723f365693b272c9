"""Pod-scale serving front end: per-host admission over one shared mesh.

The port of ``repro.serving.pod``. ``make_pod_serve_step``
(``repro_torch.serving.sharded``) is the pod's program: every rank scores
the pod-global query batch against its local doc shards and joins the
id-canonical cross-host k-merge. This module is its host side:

  * :class:`PodServer`: one ingestion host's :class:`AnytimeServer`, with
    the same rho ladder, cost model and service-time EMA the admission
    queue consumes, but every dispatch embeds the host's local ``[B]``
    block into the pod-global ``[hosts * B]`` batch (absent hosts' rows are
    inert sentinels, see ``repro_torch.serving.bucketing.sentinel_rows``)
    and runs the pod serve step, in process. One process therefore plays
    any one host of a pod.
  * :class:`PodFrontEnd`: the whole pod in one object, one
    :class:`~repro_torch.serving.queue.AdmissionQueue` a host, all feeding
    the same mesh, with merged counter export.

Serving counters are derived at scrape time from the queues' flush logs and
the servers' dispatch tallies: nothing on the serve path counts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.daat import max_blocks_per_term
from repro_torch.core.impact_index import ImpactIndex
from repro_torch.core.index_handle import search_delta_pool
from repro_torch.core.saat import max_segments_per_term
from repro_torch.core.topk import merge_pools_by_id
from repro_torch.distributed.sharding import Mesh
from repro_torch.metrics.latency import Clock
from repro_torch.serving.counters import CounterRegistry
from repro_torch.serving.queue import AdmissionQueue, Completion
from repro_torch.serving.scheduler import AnytimeServer, ServingConfig, index_static_signature
from repro_torch.serving.sharded import make_pod_serve_step


@dataclasses.dataclass(frozen=True)
class PodResult:
    """One host's block of the pod-merged answer (no per-rank WorkStats:
    the merge consumes only the k-pools, so survivor counts never leave
    their rank)."""

    scores: torch.Tensor  # f32[B, k]
    doc_ids: torch.Tensor  # i32[B, k]


def pod_hosts(mesh: Mesh) -> int:
    """Number of ingestion hosts = product of the data-group axis sizes."""
    n = 1
    for name in mesh.axis_names:
        if name != "model":
            n *= int(mesh.shape[name])
    return n


def _per_shard_ladder(ladder: Sequence[int], index_stack: ImpactIndex) -> tuple[int, ...]:
    """The rho ladder capped at the per-shard posting count (the stack's
    trailing postings dim, not ``n_postings``, which on a stack is the shard
    count), topped by that exact level."""
    exact = int(index_stack.doc_ids.shape[1])
    return tuple(sorted({min(r, exact) for r in ladder} | {exact}))


class PodServer(AnytimeServer):
    """One ingestion host's anytime server over a pod mesh.

    Inherits the queue-facing surface of :class:`AnytimeServer`
    (``pick_rho``, ``predict_service_ms``, ``pick_degraded_rho``,
    ``search_batch``, ``warmup``, all keyed on the host's LOCAL batch
    shape) and reroutes the engine dispatch through the pod serve step:

      * ``rho_ladder`` caps at the per-shard posting count, topped by the
        exact level: every shard scans all of its postings;
      * ``engine_fn(rho)`` pads the local block to the pod-global batch,
        runs the pod step, and slices the host's rows back out.
        ``serve_step(rho)`` is the step itself, carrying ``.statics``.
    """

    def __init__(
        self,
        mesh: Mesh,
        index_stack: ImpactIndex,
        cfg: ServingConfig,
        *,
        docs_per_shard: int,
        n_docs_total: Optional[int] = None,
        host: int = 0,
        clock: Optional[Clock] = None,
    ):
        super().__init__(index_stack, cfg, clock)
        self.mesh = mesh
        self.n_hosts = pod_hosts(mesh)
        if not (0 <= host < self.n_hosts):
            raise ValueError(f"host={host} outside the pod's {self.n_hosts} hosts")
        self.host = int(host)
        self.docs_per_shard = int(docs_per_shard)
        self.n_docs_total = n_docs_total
        self.rho_ladder = _per_shard_ladder(cfg.rho_ladder, index_stack)
        # the step cache, one step a ladder level (None: DAAT)
        self._steps: dict[Optional[int], object] = {}
        self.n_pod_dispatches: dict[tuple[str, Optional[int]], int] = {}
        # the index lifecycle at pod scale: a per-shard tombstone stack
        # rides the live-masked step; the (corpus-global) delta pool is
        # searched on this host and merged by gid AFTER the pod k-merge
        # hands back this host's rows: the delta never crosses the ranks
        self._live_stack: Optional[torch.Tensor] = None
        self._delta_index: Optional[ImpactIndex] = None
        self._delta_gids: Optional[torch.Tensor] = None

    # --------------------------- index lifecycle ---------------------------

    def set_lifecycle(
        self,
        *,
        live_stack=None,
        delta: Optional[ImpactIndex] = None,
        delta_gids=None,
        generation: Optional[int] = None,
        decay: float = 0.5,
    ):
        """Install (or clear) this host's view of the mutable corpus.

        ``live_stack`` is the per-shard tombstone bitmap
        (:func:`repro_torch.serving.sharded.shard_live_stack`); ``delta`` +
        ``delta_gids`` the pending-docs segment with its local->gid map.
        Toggling the live mask switches between the masked and unmasked
        steps, so the step cache is dropped on that edge only. A
        ``generation`` bump decays, never discards, the calibration, as
        :meth:`AnytimeServer.swap_index` does.
        """
        if (delta is None) != (delta_gids is None):
            raise ValueError("delta and delta_gids must be set (or cleared) together")
        was_masked = self._live_stack is not None
        dev = self.device
        self._live_stack = (
            None if live_stack is None
            else torch.as_tensor(live_stack, dtype=torch.int32, device=dev)
        )
        if (self._live_stack is not None) != was_masked:
            self._steps.clear()
        self._delta_index = delta
        self._delta_gids = (
            None if delta_gids is None
            else torch.as_tensor(delta_gids, dtype=torch.int32, device=dev)
        )
        if generation is not None and generation != self.generation:
            self.generation = int(generation)
            self._decay_calibration(decay)

    def swap_stack(
        self,
        index_stack: ImpactIndex,
        *,
        live_stack=None,
        delta: Optional[ImpactIndex] = None,
        delta_gids=None,
        generation: Optional[int] = None,
        decay: float = 0.5,
        docs_per_shard: Optional[int] = None,
        n_docs_total: Optional[int] = None,
    ):
        """Hot-swap a recompacted shard stack between admission-queue flushes.

        Rebinds the stack and its build-time bounds, rebuilds the per-shard
        rho ladder, drops the step cache, and installs the new lifecycle
        state. A compaction usually changes the shard geometry (docs fold
        out, the gid space grows), so pass the re-shard's ``docs_per_shard``
        / ``n_docs_total`` with the stack. Calibration survives decayed.
        """
        if docs_per_shard is not None:
            self.docs_per_shard = int(docs_per_shard)
        if n_docs_total is not None:
            self.n_docs_total = int(n_docs_total)
        self.index = index_stack
        self.max_segs = max_segments_per_term(index_stack)
        self.max_bm = max_blocks_per_term(index_stack)
        self.rho_ladder = _per_shard_ladder(self.cfg.rho_ladder, index_stack)
        self._steps.clear()
        gen = generation if generation is not None else self.generation + 1
        self.set_lifecycle(
            live_stack=live_stack, delta=delta, delta_gids=delta_gids,
            generation=gen, decay=decay,
        )

    # ------------------------- pod step plumbing ---------------------------

    def serve_step(self, rho: Optional[int] = None):
        """The pod serve step for one SAAT ladder level (or DAAT), built
        once and cached; it carries ``.statics`` (``merge_fanin`` among
        them)."""
        key = self._rho_key(rho)
        if key not in self._steps:
            cfg = self.cfg
            serve, _, _ = make_pod_serve_step(
                self.mesh,
                k=cfg.k,
                rho_per_shard=self.rho_ladder[-1] if key is None else key,
                max_segs_per_term=self.max_segs,
                docs_per_shard=self.docs_per_shard,
                scatter_impl=cfg.scatter_impl,
                fused_topk=cfg.fused_topk,
                engine=cfg.engine,
                daat_est_blocks=cfg.daat_est_blocks,
                daat_block_budget=cfg.daat_block_budget,
                max_bm_per_term=self.max_bm if cfg.engine == "daat" else 0,
                daat_exact=cfg.daat_exact,
                daat_use_kernels=cfg.daat_use_kernels,
                daat_fused_chunk=cfg.daat_fused_chunk,
                daat_trips_per_launch=cfg.daat_trips_per_launch,
                n_docs_total=self.n_docs_total,
                live_masked=self._live_stack is not None,
            )
            self._steps[key] = serve
        return self._steps[key]

    def _pod_dispatch(self, qt, qw, rho: Optional[int]) -> PodResult:
        key = self._rho_key(rho)
        serve = self.serve_step(rho)
        dev = self.device
        qt = torch.as_tensor(qt, dtype=torch.int32, device=dev)
        qw = torch.as_tensor(qw, dtype=torch.float32, device=dev)
        B, width = qt.shape
        lo, hi = self.host * B, (self.host + 1) * B
        # the other hosts' blocks are inert sentinel rows (all pad ids,
        # zero weights)
        gqt = qt.new_full((self.n_hosts * B, width), self.index.n_terms)
        gqw = qw.new_zeros((self.n_hosts * B, width))
        gqt[lo:hi] = qt
        gqw[lo:hi] = qw
        scores, ids = serve(self.index, gqt, gqw, live_stack=self._live_stack)
        self.n_pod_dispatches[(self.cfg.engine, key)] = (
            self.n_pod_dispatches.get((self.cfg.engine, key), 0) + 1
        )
        scores, ids = scores[lo:hi], ids[lo:hi]
        if self._delta_index is not None:
            # the host-local freshness merge: the pending-docs pool is
            # searched exactly on this host and merged by gid with the pod
            # answer, as the single-host IndexHandle merges, so ties still
            # resolve ascending-gid
            ds, dlocal = search_delta_pool(
                self._delta_index, qt, qw, k=self.cfg.k,
                engine=self.cfg.engine, scatter_impl=self.cfg.scatter_impl,
                fused_topk=self.cfg.fused_topk,
            )
            dgids = self._delta_gids[dlocal.long()]
            scores, ids = merge_pools_by_id(scores, ids, ds, dgids, self.cfg.k)
        return PodResult(scores=scores, doc_ids=ids)

    # ------------------------ AnytimeServer overrides ----------------------

    def engine_fn(self, rho: Optional[int] = None):
        if self.cfg.engine == "daat":
            return self._daat_search
        if rho is None:
            rho = self.rho_ladder[-1]

        def fn(qt, qw, _rho=rho):
            return self._pod_dispatch(qt, qw, _rho)

        return fn

    def _daat_search(self, q_terms, q_weights):
        return self._pod_dispatch(q_terms, q_weights, None)

    def executable_key(
        self, lq_bucket: int, batch_size: int, rho: Optional[int] = None
    ) -> tuple:
        # the pod program differs from the single-host engine at equal
        # engine statics (gathers, shard layout), and its batch is hosts * B
        # wide: fold the pod identity AND the lifecycle's static surface
        # (mask presence, delta shapes) into the key; the generation stays
        # out, as in AnytimeServer.executable_key
        base = super().executable_key(lq_bucket, batch_size, rho)
        lifecycle = (
            "live" if self._live_stack is not None else None,
            None if self._delta_index is None
            else index_static_signature(self._delta_index),
        )
        return ("pod", self.n_hosts, int(self.mesh.shape["model"]),
                self.docs_per_shard, self.n_docs_total) + lifecycle + base

    # ----------------------------- counters --------------------------------

    def export_counters(self, registry: Optional[CounterRegistry] = None) -> CounterRegistry:
        """Scrape-time serving counters for this host's dispatch path."""
        reg = registry if registry is not None else CounterRegistry()
        host = str(self.host)
        disp = reg.counter(
            "repro_pod_dispatch_total",
            "Pod serve-step dispatches by host, engine and served rho",
        )
        for (engine, rho), n in sorted(
            self.n_pod_dispatches.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))
        ):
            disp.labels(host=host, engine=engine, rho="none" if rho is None else str(rho)).inc(n)
        fanin = reg.gauge(
            "repro_pod_merge_fanin",
            "Candidates entering the cross-host k-merge (ranks * k)",
        )
        for key, serve in self._steps.items():
            fanin.labels(
                host=host, rho="none" if key is None else str(key)
            ).set(serve.statics["merge_fanin"])
        return reg


class PodFrontEnd:
    """The whole pod in one process: per-host admission queues, one mesh.

    Host ``h`` gets its own :class:`PodServer` (embedding its flushes at
    block ``h`` of the pod batch) and its own :class:`AdmissionQueue` over
    it: per-host admission is the deployment shape the paper's traffic
    claim needs.
    """

    def __init__(
        self,
        mesh: Mesh,
        index_stack: ImpactIndex,
        cfg: ServingConfig,
        *,
        docs_per_shard: int,
        n_docs_total: Optional[int] = None,
        clock: Optional[Clock] = None,
        queue_kwargs: Optional[dict] = None,
    ):
        self.mesh = mesh
        self.n_hosts = pod_hosts(mesh)
        self.servers = [
            PodServer(
                mesh, index_stack, cfg,
                docs_per_shard=docs_per_shard, n_docs_total=n_docs_total,
                host=h, clock=clock,
            )
            for h in range(self.n_hosts)
        ]
        qkw = dict(queue_kwargs or {})
        self.queues = [AdmissionQueue(srv, **qkw) for srv in self.servers]

    def submit(self, host: int, q_terms, q_weights, deadline_ms: Optional[float] = None) -> int:
        return self.queues[host].submit(q_terms, q_weights, deadline_ms)

    def poll(self) -> list[tuple[int, Completion]]:
        out: list[tuple[int, Completion]] = []
        for h, q in enumerate(self.queues):
            out.extend((h, c) for c in q.poll())
        return out

    def drain(self) -> list[tuple[int, Completion]]:
        out: list[tuple[int, Completion]] = []
        for h, q in enumerate(self.queues):
            out.extend((h, c) for c in q.drain())
        return out

    def pending(self) -> int:
        return sum(q.pending() for q in self.queues)

    def set_lifecycle(self, **kwargs):
        """Install lifecycle state (tombstone stack / delta pool) on every
        host's server; see :meth:`PodServer.set_lifecycle`."""
        for srv in self.servers:
            srv.set_lifecycle(**kwargs)
        if kwargs.get("generation") is not None:
            for q in self.queues:
                q.survivors.decay(kwargs.get("decay", 0.5))

    def swap_stack(self, index_stack: ImpactIndex, **kwargs):
        """Hot-swap a recompacted shard stack on every host between
        flushes; pending requests ride (the zero-loss argument of
        :meth:`AdmissionQueue.swap_index` holds a host queue at a time)."""
        for srv in self.servers:
            srv.swap_stack(index_stack, **kwargs)
        for q in self.queues:
            q.survivors.decay(kwargs.get("decay", 0.5))

    def export_counters(self, registry: Optional[CounterRegistry] = None) -> CounterRegistry:
        reg = registry if registry is not None else CounterRegistry()
        for h, (srv, q) in enumerate(zip(self.servers, self.queues)):
            q.export_counters(reg, labels={"host": str(h)})
            srv.export_counters(reg)
        return reg


def warmup_pod(
    front: PodFrontEnd,
    q_terms,
    q_weights,
    *,
    batch_sizes: Optional[Sequence[int]] = None,
    repeats: int = 1,
):
    """Calibrate every host's grid of batch shapes (each host's server
    keeps its own service-time EMA)."""
    for srv in front.servers:
        srv.warmup(q_terms, q_weights, repeats=repeats, batch_sizes=batch_sizes)
