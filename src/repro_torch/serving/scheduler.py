"""Anytime serving: batched queries and deadline -> rho control.

The port of ``repro.serving.scheduler`` (one device; doc sharding across
devices is not ported yet). SAAT's posting budget rho makes query cost
predictable; this module turns that into a deadline controller: given a
target latency, pick the largest rho whose predicted cost fits. The
controller works on a ladder of rho levels, each served as one batched
``saat_search`` over the whole ``[B, Lq]`` batch. The server can also run
block-max DAAT (``engine="daat"``), whose cost is data-dependent.

Two serving-layer properties make the continuous-batching admission queue
(``repro_torch.serving.queue``) possible:

  * **Lq bucketing** (``ServingConfig.lq_buckets``): each batch is padded to
    the smallest bucket width covering its live terms, so the set of batch
    shapes is (rho-or-engine-config) x (Lq bucket), and results are
    bit-identical to the max-Lq pad (see ``repro_torch.serving.bucketing``).
  * **Injectable time** (``clock=``): every latency measurement and the cost
    model's calibration read a :class:`repro_torch.metrics.latency.Clock`,
    so the queue's deadline-driven flush policy can be tested on a
    simulated clock.

On the device: the server runs on its index's device. A batch arrives as
host arrays (or tensors), is bucketed on the host and moved to the device
inside the timed window, and the window closes only after the device has
finished (``torch.cuda.synchronize``), so a latency, the cost model's EMA
and the queue's deadline policy measure the device's work and not only the
host's enqueue. ``warmup`` builds the CUDA kernels its configuration
launches before it times anything, so the build never lands in the cost
model. PyTorch keeps no compile cache: ``executable_key`` names a dispatch
by the reference's static surface, and keys the per-shape service EMA and
the warm-up grid.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.daat import DAAT_STATICS, daat_search_batched, max_blocks_per_term
from repro_torch.core.impact_index import ARRAY_FIELDS, META_FIELDS, ImpactIndex
from repro_torch.core.index_handle import IndexHandle
from repro_torch.core.saat import (
    SAAT_STATICS,
    SCATTER_IMPLS,
    max_segments_per_term,
    saat_search,
)
from repro_torch.kernels import common
from repro_torch.metrics.latency import Clock, LatencyStats, SystemClock, summarize_latencies
from repro_torch.serving.bucketing import bucketize_batch, normalize_buckets, pad_to_width

_UNSET = object()  # pick_rho sentinel: "use cfg.deadline_ms"


def index_static_signature(ix: ImpactIndex) -> tuple:
    """Hashable shape-level signature of one ``ImpactIndex`` segment: the
    meta fields plus every tensor field's shape, in the reference's order,
    so a key equals the reference's for the same index."""
    meta = tuple(getattr(ix, f) for f in META_FIELDS)
    shapes = tuple(tuple(int(n) for n in getattr(ix, f).shape) for f in ARRAY_FIELDS)
    return meta + shapes


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    k: int = 1000
    rho_ladder: tuple[int, ...] = (100_000, 500_000, 1_000_000, 5_000_000, 10_000_000)
    batch_size: int = 32
    deadline_ms: Optional[float] = None  # None = always use max rho
    # the port's names: "scatter", "sort" or "kernel" (the reference's
    # "jnp", "sort" and "pallas")
    scatter_impl: str = "sort"
    # fuse SAAT's top-k into the scatter kernel (impact_scatter_topk): the
    # [B, n_docs] accumulator never reaches device memory; scatter_impl is
    # then ignored
    fused_topk: bool = False
    ema_alpha: float = 0.2  # cost-model smoothing
    # engine selection: "saat" (anytime, rho ladder) or "daat" (block-max
    # pruning; data-dependent cost, no rho control)
    engine: str = "saat"
    daat_est_blocks: int = 8
    daat_block_budget: int = 16
    daat_exact: bool = True
    # route DAAT through the CUDA kernels (block_prune_csr, block_topk,
    # sparse_score); False keeps the plain formulation
    daat_use_kernels: bool = False
    # run every phase-2 trip as one chunk_step launch (needs
    # daat_use_kernels=True)
    daat_fused_chunk: bool = False
    # up to this many phase-2 trips in one chunk_step launch (needs
    # daat_fused_chunk=True); clamped to 1 when daat_exact=False
    daat_trips_per_launch: int = 1
    # Lq bucket widths: each batch is padded to the smallest bucket covering
    # its live terms (bit-identical results); None pads to whatever width
    # the caller sends
    lq_buckets: Optional[tuple[int, ...]] = None


@dataclasses.dataclass
class _CostModel:
    """us per million postings, learned online per rho level.

    ``clock`` stamps each level's last calibration time. A level is
    *calibrated* once it has been directly measured. Predictions for
    unmeasured levels interpolate piecewise-linearly in *total cost* between
    the two bracketing calibrated levels. Above the calibrated range the
    boundary level's per-Mpost rate extrapolates linearly; BELOW it the
    prediction floors at the boundary level's measured total (fixed per-call
    overhead does not shrink with rho). ``predict_us`` returns ``None`` only
    when nothing has been measured at all.
    """

    us_per_mpost: dict
    alpha: float
    clock: Clock = dataclasses.field(default_factory=SystemClock)
    last_update_s: dict = dataclasses.field(default_factory=dict)
    # per-level confidence in [0, 1]: 1.0 = the EMA is fully trusted (the
    # steady state; update() then smooths at exactly `alpha`). A hot swap
    # decays confidence instead of discarding the value: the next
    # observations blend in faster until confidence recovers.
    confidence: dict = dataclasses.field(default_factory=dict)

    def update(self, rho: int, elapsed_us: float):
        per = elapsed_us / max(rho / 1e6, 1e-9)
        conf = self.confidence.get(rho, 1.0)
        a = self.alpha + (1.0 - self.alpha) * (1.0 - conf)
        old = self.us_per_mpost.get(rho)
        self.us_per_mpost[rho] = per if old is None else (1 - a) * old + a * per
        self.confidence[rho] = 1.0 - (1.0 - conf) * (1.0 - self.alpha)
        self.last_update_s[rho] = self.clock.now()

    def decay(self, factor: float):
        """Generation bump: keep every calibrated value, shrink its trust."""
        for rho in self.us_per_mpost:
            self.confidence[rho] = self.confidence.get(rho, 1.0) * factor

    def is_calibrated(self, rho: int) -> bool:
        return rho in self.us_per_mpost

    def predict_us(self, rho: int) -> Optional[float]:
        if not self.us_per_mpost:
            return None
        levels = sorted(self.us_per_mpost)
        # below the calibrated range: floor at the boundary level's TOTAL
        if rho <= levels[0]:
            return self.us_per_mpost[levels[0]] * levels[0] / 1e6
        # above it: the boundary RATE extrapolates linearly
        if rho >= levels[-1]:
            return self.us_per_mpost[levels[-1]] * rho / 1e6
        hi_ix = bisect.bisect_left(levels, rho)
        lo, hi = levels[hi_ix - 1], levels[hi_ix]
        total_lo = self.us_per_mpost[lo] * lo / 1e6
        total_hi = self.us_per_mpost[hi] * hi / 1e6
        frac = (rho - lo) / (hi - lo)
        return total_lo + frac * (total_hi - total_lo)


class AnytimeServer:
    """Batched SAAT (or DAAT) serving over one impact index, or a mutable
    :class:`IndexHandle`.

    Every ``search_batch`` call runs the batched engine once. The plan
    bound ``max_segs`` comes from the index's build-time metadata, so
    constructing a server reads nothing back from the device.

    With an :class:`IndexHandle` the server is lifecycle-aware: dispatches
    serve (main - tombstones) + delta through the handle's merged search
    (rho budgets the MAIN segment only; the delta is always exact), and
    :meth:`swap_index` hot-swaps to a freshly compacted main between
    admission-queue flushes, bumping ``generation`` and *decaying* (never
    discarding) the service-time calibration.
    """

    def __init__(
        self,
        index: ImpactIndex | IndexHandle,
        cfg: ServingConfig,
        clock: Optional[Clock] = None,
    ):
        if cfg.engine not in ("saat", "daat"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        if cfg.scatter_impl not in SCATTER_IMPLS:
            raise ValueError(
                f"unknown scatter_impl {cfg.scatter_impl!r}; the port's names are {SCATTER_IMPLS}"
            )
        if cfg.daat_fused_chunk and not cfg.daat_use_kernels:
            raise ValueError(
                "daat_fused_chunk fuses the kernel-mode chunk step; set daat_use_kernels=True"
            )
        if cfg.daat_trips_per_launch < 1:
            raise ValueError(f"daat_trips_per_launch={cfg.daat_trips_per_launch} must be >= 1")
        if cfg.daat_trips_per_launch > 1 and not cfg.daat_fused_chunk:
            raise ValueError(
                "daat_trips_per_launch > 1 batches trips inside the fused chunk_step kernel; "
                "set daat_fused_chunk=True (and daat_use_kernels=True)"
            )
        self.handle: Optional[IndexHandle] = None
        if isinstance(index, IndexHandle):
            self.handle = index
        else:
            self.index = index
        self.cfg = cfg
        self.clock: Clock = clock if clock is not None else SystemClock()
        self.generation = self.handle.generation if self.handle is not None else 0
        self._latencies_ms: list[float] = []
        self._rhos: list[int] = []
        self._cost = _CostModel({}, cfg.ema_alpha, clock=self.clock)
        # whole-batch wall-ms EMA keyed by (engine, Lq bucket, batch shape,
        # rho): a batch's wall time is far from linear in B, so the queue's
        # service-time estimate is learned per shape; each SAAT ladder level
        # keys its own (DAAT keys with rho=None)
        self._bucket_ms: dict[tuple[str, int, int, Optional[int]], float] = {}
        # per-key calibration confidence (1.0 = steady state; see _CostModel)
        self._bucket_conf: dict[tuple[str, int, int, Optional[int]], float] = {}
        self.lq_buckets = (
            normalize_buckets(cfg.lq_buckets) if cfg.lq_buckets is not None else None
        )
        self._bind_main_segment()

    def _bind_main_segment(self):
        """(Re)derive what depends on the current main segment: the plan
        bounds (build-time metadata) and the rho ladder cap (the exact level
        IS the main segment's posting count)."""
        index = self.handle.main if self.handle is not None else self.index
        self.index = index
        self.max_segs = max_segments_per_term(index)
        self.max_bm = max_blocks_per_term(index)
        exact = index.n_postings
        ladder = sorted({min(r, exact) for r in self.cfg.rho_ladder} | {exact})
        self.rho_ladder = tuple(ladder)

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _sync(self):
        """Wait for the device, so a clock reading covers its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def kernel_names(self) -> list[str]:
        """The CUDA kernels this configuration launches (``csrc`` stems)."""
        cfg = self.cfg
        if cfg.engine == "daat":
            if not cfg.daat_use_kernels:
                return []
            names = ["block_prune_csr", "block_topk", "sparse_score"]
            return names + (["chunk_step"] if cfg.daat_fused_chunk else [])
        if cfg.fused_topk:
            return ["impact_scatter_topk"]
        return ["impact_scatter"] if cfg.scatter_impl == "kernel" else []

    # -------------------------- index lifecycle ----------------------------

    def swap_index(self, handle: Optional[IndexHandle] = None, *, decay: float = 0.5):
        """Hot-swap to the handle's current main segment (between queue
        flushes, after :meth:`IndexHandle.compact`, or to adopt a new
        handle): rebind the main-segment statics, take the handle's
        ``generation``, and decay (never discard) every calibration by
        ``decay``."""
        if handle is not None:
            self.handle = handle
        if self.handle is None:
            raise ValueError(
                "swap_index needs a handle-backed server; construct the "
                "AnytimeServer with an IndexHandle"
            )
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay}")
        self._bind_main_segment()
        self.generation = self.handle.generation
        self._decay_calibration(decay)

    def _decay_calibration(self, decay: float):
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay}")
        for key in self._bucket_ms:
            self._bucket_conf[key] = self._bucket_conf.get(key, 1.0) * decay
        self._cost.decay(decay)

    # -------------------------- rho selection -----------------------------

    def pick_rho(self, deadline_ms=_UNSET) -> int:
        """Largest *calibrated* ladder level whose predicted cost fits.

        ``deadline_ms`` overrides ``cfg.deadline_ms``; ``None`` means no
        deadline -> max rho. An uncalibrated level is never treated as free:
        when no calibrated level fits, fall back to the *smallest*
        uncalibrated one, and only then to the smallest level outright.
        """
        deadline = self.cfg.deadline_ms if deadline_ms is _UNSET else deadline_ms
        if deadline is None:
            return self.rho_ladder[-1]
        budget_us = deadline * 1e3
        calibrated_fit = [
            rho
            for rho in self.rho_ladder
            if self._cost.is_calibrated(rho) and self._cost.predict_us(rho) <= budget_us
        ]
        if calibrated_fit:
            return calibrated_fit[-1]  # ladder is sorted ascending
        uncalibrated = [r for r in self.rho_ladder if not self._cost.is_calibrated(r)]
        if uncalibrated:
            return uncalibrated[0]
        return self.rho_ladder[0]

    # ------------------------ queue-facing predictions ---------------------

    def _rho_key(self, rho: Optional[int]) -> Optional[int]:
        """Canonical rho component of the service-time key (None for DAAT)."""
        if self.cfg.engine == "daat":
            return None
        return int(rho) if rho is not None else self.pick_rho()

    def predict_service_ms(self, n_queries: int, lq_bucket: int, rho: Optional[int] = None) -> float:
        """Predicted wall time to serve an ``[n_queries, lq_bucket]`` batch.

        Prefers the per-(engine, bucket, batch-shape, rho) EMA of observed
        whole-batch wall times. When the exact shape is uncalibrated, the
        nearest calibrated shape in the same lane stands in: unscaled for a
        smaller shape, ratio-scaled upward for a LARGER one. SAAT falls back
        to the rho cost model only when no shape in the lane is calibrated,
        and the result is 0.0 when nothing is known (the queue then flushes
        exactly at the deadline).
        """
        eng, bucket, shape = self.cfg.engine, int(lq_bucket), int(n_queries)
        rk = self._rho_key(rho)
        batch_ms = self._bucket_ms.get((eng, bucket, shape, rk))
        if batch_ms is not None:
            return batch_ms
        shapes = [b for (e, bk, b, r) in self._bucket_ms if e == eng and bk == bucket and r == rk]
        if shapes:
            nearest = min(shapes, key=lambda b: (abs(b - shape), b))
            batch_ms = self._bucket_ms[(eng, bucket, nearest, rk)]
            if shape > nearest:  # conservative upper bound, never a late flush
                return batch_ms * shape / nearest
            return batch_ms
        if eng == "saat":
            pred_us = self._cost.predict_us(rk)
            if pred_us is not None:
                return pred_us / 1e3 * n_queries
        return 0.0

    def service_calibrated(self, lq_bucket: int, rho: Optional[int] = None) -> bool:
        """True when some batch shape in the (engine, bucket, rho) lane has
        been directly measured."""
        eng, bucket, rk = self.cfg.engine, int(lq_bucket), self._rho_key(rho)
        return any(e == eng and bk == bucket and r == rk for (e, bk, _b, r) in self._bucket_ms)

    def pick_degraded_rho(self, n_queries: int, lq_bucket: int, remaining_ms: float) -> int:
        """Largest *calibrated* ladder level whose predicted service for this
        ``[n_queries, lq_bucket]`` flush still fits in ``remaining_ms`` (the
        queue's degrade-instead-of-violate policy). When none fits, the
        SMALLEST calibrated level; with nothing calibrated, :meth:`pick_rho`'s
        deadline logic."""
        fit = [
            rho
            for rho in self.rho_ladder
            if self.service_calibrated(lq_bucket, rho)
            and self.predict_service_ms(n_queries, lq_bucket, rho) <= remaining_ms
        ]
        if fit:
            return fit[-1]  # ladder is sorted ascending
        calibrated = [r for r in self.rho_ladder if self.service_calibrated(lq_bucket, r)]
        if calibrated:
            return calibrated[0]
        return self.pick_rho(deadline_ms=remaining_ms)

    def _observe_bucket_ms(
        self, lq_bucket: int, batch_shape: int, batch_ms: float, rho: Optional[int] = None
    ):
        key = (self.cfg.engine, int(lq_bucket), int(batch_shape), self._rho_key(rho))
        old = self._bucket_ms.get(key)
        conf = self._bucket_conf.get(key, 1.0)
        # confidence-weighted smoothing: exactly cfg.ema_alpha at full
        # confidence; faster after a generation bump decayed it
        a = self.cfg.ema_alpha + (1.0 - self.cfg.ema_alpha) * (1.0 - conf)
        self._bucket_ms[key] = batch_ms if old is None else (1 - a) * old + a * batch_ms
        self._bucket_conf[key] = 1.0 - (1.0 - conf) * (1.0 - self.cfg.ema_alpha)

    # ----------------------------- serving --------------------------------

    def _daat_search(self, q_terms, q_weights):
        return daat_search_batched(
            self.index,
            q_terms,
            q_weights,
            k=self.cfg.k,
            est_blocks=self.cfg.daat_est_blocks,
            block_budget=self.cfg.daat_block_budget,
            max_bm_per_term=self.max_bm,
            exact=self.cfg.daat_exact,
            use_kernels=self.cfg.daat_use_kernels,
            fused_chunk=self.cfg.daat_fused_chunk,
            trips_per_launch=self.cfg.daat_trips_per_launch,
        )

    def engine_fn(self, rho: Optional[int] = None):
        """The engine dispatch of one batch shape: ``(qt, qw) -> result``,
        with every static bound. Handle-backed servers dispatch the
        handle's merged search, which reads the handle's current segments
        at call time."""
        if self.handle is not None:
            return self._handle_engine(rho)
        if self.cfg.engine == "daat":
            return self._daat_search
        if rho is None:
            rho = self.rho_ladder[-1]
        return functools.partial(
            saat_search,
            self.index,
            k=self.cfg.k,
            rho=rho,
            max_segs_per_term=self.max_segs,
            scatter_impl=self.cfg.scatter_impl,
            fused_topk=self.cfg.fused_topk,
        )

    def _handle_engine(self, rho: Optional[int] = None):
        """Merged lifecycle dispatch: ``(qt, qw) -> HandleResult``; rho
        budgets the MAIN segment only."""
        cfg = self.cfg
        if cfg.engine == "daat":
            return functools.partial(
                self.handle.daat_search,
                k=cfg.k,
                est_blocks=cfg.daat_est_blocks,
                block_budget=cfg.daat_block_budget,
                exact=cfg.daat_exact,
                use_kernels=cfg.daat_use_kernels,
                fused_chunk=cfg.daat_fused_chunk,
                trips_per_launch=cfg.daat_trips_per_launch,
            )
        return functools.partial(
            self.handle.saat_search,
            k=cfg.k,
            rho=self.rho_ladder[-1] if rho is None else rho,
            scatter_impl=cfg.scatter_impl,
            fused_topk=cfg.fused_topk,
        )

    def executable_key(self, lq_bucket: int, batch_size: int, rho: Optional[int] = None) -> tuple:
        """Hashable name of the dispatch serving this batch shape.

        The reference's structure: the engine's static surface
        (``SAAT_STATICS`` / ``DAAT_STATICS``), the index's static signature
        (every segment's meta fields and tensor shapes: a delta growing a
        block or a compaction changing the main pad width is a different
        dispatch) and the batch shape. The lifecycle ``generation`` is
        deliberately NOT in the key: two generations with identical
        signatures run the identical dispatch.
        """
        cfg = self.cfg
        if cfg.engine == "daat":
            kw = dict(k=cfg.k, est_blocks=cfg.daat_est_blocks,
                      block_budget=cfg.daat_block_budget, max_bm_per_term=self.max_bm,
                      exact=cfg.daat_exact, use_kernels=cfg.daat_use_kernels,
                      fused_chunk=cfg.daat_fused_chunk,
                      trips_per_launch=cfg.daat_trips_per_launch)
            # the server never caps the trips (max_chunks stays None)
            statics = ("daat",) + tuple(kw[n] for n in DAAT_STATICS if n != "max_chunks")
        else:
            kw = dict(k=cfg.k, rho=self.rho_ladder[-1] if rho is None else rho,
                      max_segs_per_term=self.max_segs, scatter_impl=cfg.scatter_impl,
                      fused_topk=cfg.fused_topk)
            statics = ("saat",) + tuple(kw[n] for n in SAAT_STATICS)
        return statics + self._index_signature() + (int(lq_bucket), int(batch_size))

    def _index_signature(self) -> tuple:
        """One entry per segment: main, a marker for the tombstone mask, and
        the delta (``None`` when empty: no merge runs)."""
        if self.handle is None:
            return (index_static_signature(self.index),)
        d = self.handle.delta
        return (
            index_static_signature(self.handle.main),
            "live",
            None if d is None else index_static_signature(d),
        )

    def _bucketize(self, q_terms, q_weights) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Pad the batch to its Lq bucket on the host, canonicalize dtypes
        (i32 terms, f32 weights: one dispatch per key) and move it to the
        device."""
        dev = self.device
        if self.lq_buckets is None:
            qt = torch.as_tensor(q_terms, dtype=torch.int32, device=dev)
            qw = torch.as_tensor(q_weights, dtype=torch.float32, device=dev)
            return qt, qw, int(qt.shape[-1])
        qt, qw, bucket = bucketize_batch(
            _host(q_terms), _host(q_weights), self.lq_buckets, self.index.n_terms
        )
        return (torch.as_tensor(qt, dtype=torch.int32, device=dev),
                torch.as_tensor(qw, dtype=torch.float32, device=dev), bucket)

    def search_batch(self, q_terms, q_weights, rho: Optional[int] = None):
        if self.cfg.engine == "daat":
            if rho is not None:
                raise ValueError(
                    "rho is a SAAT posting budget; the daat engine's cost is "
                    "data-dependent and cannot honor it"
                )
            t0 = self.clock.now()  # bucketize is service cost: keep it timed
            q_terms, q_weights, bucket = self._bucketize(q_terms, q_weights)
            res = self.engine_fn()(q_terms, q_weights)
            self._sync()
            elapsed = (self.clock.now() - t0) * 1e3
            per_query = elapsed / q_terms.shape[0]
            self._latencies_ms.extend([per_query] * q_terms.shape[0])
            self._rhos.extend([0] * q_terms.shape[0])
            self._observe_bucket_ms(bucket, q_terms.shape[0], elapsed)
            return res
        # an explicit rho must be a real ladder level
        if rho is None:
            rho = self.pick_rho()
        elif rho not in self.rho_ladder:
            raise ValueError(
                f"rho={rho!r} is not a ladder level {self.rho_ladder}; explicit "
                "budgets must hit a calibrated level"
            )
        t0 = self.clock.now()  # bucketize is service cost: keep it timed
        q_terms, q_weights, bucket = self._bucketize(q_terms, q_weights)
        res = self.engine_fn(rho)(q_terms, q_weights)
        self._sync()
        elapsed = (self.clock.now() - t0) * 1e3
        per_query = elapsed / q_terms.shape[0]
        for _ in range(q_terms.shape[0]):
            self._latencies_ms.append(per_query)
            self._rhos.append(rho)
        self._cost.update(rho, per_query * 1e3)
        self._observe_bucket_ms(bucket, q_terms.shape[0], elapsed, rho=rho)
        return res

    def warmup(
        self,
        q_terms,
        q_weights,
        repeats: int = 2,
        batch_sizes: Optional[Sequence[int]] = None,
    ):
        """Calibrate the grid of batch shapes (excluded from stats).

        The grid is (rho-or-engine-config) x (Lq bucket) x (batch size).
        ``batch_sizes`` defaults to the sample's own B; the queue passes its
        flushable shapes. On the GPU the configuration's kernels are built
        first, before any clock is read, so the build never lands in the
        cost model; each shape keeps the last of its ``repeats`` times.
        """
        if self.device.type == "cuda":
            for name in self.kernel_names():
                common.kernel_library(name)
        sizes = [int(q_terms.shape[0])] if batch_sizes is None else sorted(set(batch_sizes))
        qt_np, qw_np = _host(q_terms), _host(q_weights)
        buckets = [int(qt_np.shape[-1])] if self.lq_buckets is None else list(self.lq_buckets)
        dev = self.device
        for bucket in buckets:
            if bucket >= qt_np.shape[-1]:
                bt, bw = pad_to_width(qt_np, qw_np, bucket, self.index.n_terms)
            else:
                # slice regardless of live terms: warmup only needs the SHAPE
                bt, bw = qt_np[:, :bucket], qw_np[:, :bucket]
            for B in sizes:
                reps = np.resize(np.arange(qt_np.shape[0]), B)
                qt = torch.as_tensor(bt[reps], dtype=torch.int32, device=dev)
                qw = torch.as_tensor(bw[reps], dtype=torch.float32, device=dev)
                if self.cfg.engine == "daat":
                    for _ in range(repeats):
                        t0 = self.clock.now()
                        self.engine_fn()(qt, qw)
                        self._sync()
                        batch_ms = (self.clock.now() - t0) * 1e3
                    self._observe_bucket_ms(bucket, B, batch_ms)
                    continue
                for rho in self.rho_ladder:
                    for _ in range(repeats):
                        t0 = self.clock.now()
                        self.engine_fn(rho)(qt, qw)
                        self._sync()
                        batch_ms = (self.clock.now() - t0) * 1e3
                    self._cost.update(rho, batch_ms * 1e3 / B)
                    # per-rho key: each ladder level is its own dispatch
                    self._observe_bucket_ms(bucket, B, batch_ms, rho=rho)

    def stats(self) -> LatencyStats:
        return summarize_latencies(self._latencies_ms)

    def reset_stats(self):
        self._latencies_ms.clear()
        self._rhos.clear()

    def export_counters(self, registry=None):
        """Scrape-time serving counters derived from state the server
        already keeps (query tallies, the shape-keyed service-time EMA, the
        lifecycle); nothing is counted on the hot path."""
        from repro_torch.serving.counters import CounterRegistry

        reg = registry if registry is not None else CounterRegistry()
        reg.counter(
            "repro_server_queries_total", "Queries served (per-request rows)"
        ).labels(engine=self.cfg.engine).inc(len(self._latencies_ms))
        cal = reg.gauge(
            "repro_server_calibrated_shapes",
            "Directly measured (bucket, batch-shape, rho) executables",
        )
        cal.labels(engine=self.cfg.engine).set(len(self._bucket_ms))
        ema = reg.gauge(
            "repro_server_service_ms",
            "EMA whole-batch wall ms per (bucket, batch shape, rho) executable",
        )
        for (eng, bucket, shape, rho), ms in sorted(
            self._bucket_ms.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2], str(kv[0][3]))
        ):
            ema.labels(
                engine=eng, bucket=str(bucket), shape=str(shape),
                rho="none" if rho is None else str(rho),
            ).set(ms)
        reg.gauge(
            "repro_index_generation",
            "Index lifecycle generation (bumped by each hot-swapped compaction)",
        ).labels(engine=self.cfg.engine).set(self.generation)
        if self.handle is not None:
            reg.gauge(
                "repro_index_tombstones",
                "Deleted/updated docs masked -inf in the main segment",
            ).labels(engine=self.cfg.engine).set(self.handle.tombstone_count)
            reg.gauge(
                "repro_index_delta_docs",
                "Docs pending in the append-only delta segment",
            ).labels(engine=self.cfg.engine).set(self.handle.delta_docs)
        return reg


def run_query_stream(
    server: AnytimeServer,
    q_terms: np.ndarray,  # [N, Lq]
    q_weights: np.ndarray,
    *,
    batch_size: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Drive a query stream through the server in fixed batches.

    Returns host arrays (scores [N, k], doc_ids [N, k]). The final ragged
    batch is padded with repeats (served, then dropped) so every batch has
    one shape.
    """
    bs = batch_size or server.cfg.batch_size
    q_terms, q_weights = _host(q_terms), _host(q_weights)
    N = q_terms.shape[0]
    out_s, out_i = [], []
    for lo in range(0, N, bs):
        hi = min(lo + bs, N)
        qt = q_terms[lo:hi]
        qw = q_weights[lo:hi]
        if hi - lo < bs:  # pad final batch
            pad = bs - (hi - lo)
            qt = np.concatenate([qt, np.repeat(qt[-1:], pad, 0)])
            qw = np.concatenate([qw, np.repeat(qw[-1:], pad, 0)])
        res = server.search_batch(qt, qw)
        out_s.append(res.scores.cpu().numpy()[: hi - lo])
        out_i.append(res.doc_ids.cpu().numpy()[: hi - lo])
    return np.concatenate(out_s), np.concatenate(out_i)
