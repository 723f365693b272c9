"""Generation-based mutable index lifecycle over immutable ``ImpactIndex``es.

The port of ``repro.core.index_handle``. Every engine consumes an immutable
:class:`ImpactIndex`; ``IndexHandle`` serves a living corpus with the
classic LSM-ish triple:

  * a **main** segment: the big immutable ``ImpactIndex`` (global doc id
    ``gid`` == main-local doc id);
  * a **delta** segment: a small ``ImpactIndex`` rebuilt on the host on
    every mutation from the raw added/updated documents, with local ids
    assigned in ascending-gid order and the SAME quantization grid and
    block size as main (so the cross-segment score units hold);
  * a **tombstone bitmap**: deleted (or updated-in-place) main docs flip a
    bit; the engines' ``live_mask`` paths score them ``-inf`` with no
    rebuild.

Search = engine over main (tombstones masked) + exact search over delta
(delta-local ids mapped back to gids) + :func:`merge_pools_by_id`, whose
stable id-ascending reorder reproduces the dense accumulator's tie order,
so a mutated handle answers as a from-scratch rebuild of the post-mutation
corpus over the same gid space with the same tombstone mask does.

Compaction (:meth:`IndexHandle.compact`) folds main + delta - tombstones
into a fresh main segment and bumps ``generation``; the serving layers
hot-swap on that counter between admission-queue flushes. Tombstoned gids
stay dead (gids are never re-used).

Quantization is stable across compactions: the doc-major store holds
dequantized impacts ``q * scale``; the compactor recovers ``q = round(w /
scale)`` and feeds the builder mid-step weights ``(q - 0.5) * scale`` on
the pinned grid, which re-quantize to exactly ``q``. Uniform quantization
only (the repo default).

On the device: the segments, the tombstone bitmap (``live_mask``) and the
delta's local-to-gid map live on the device of the main segment, and are
uploaded again after every mutation that changes them. Every build runs on
the host and is then placed on that device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import daat, saat
from repro_torch.core.impact_index import (
    ImpactIndex,
    build_impact_index,
    extract_doc_coo,
    queries_on_device,
)
from repro_torch.core.quantization import QuantConfig
from repro_torch.core.topk import merge_pools_by_id, topk


class HandleResult(NamedTuple):
    """Merged top-k over (main - tombstones) + delta.

    ``main`` is the engine's result over the main segment (its ``WorkStats``
    describe the budgeted part of the search); ``delta`` is the delta pool
    (``None`` when the delta is empty: no merge, and ``scores/doc_ids`` are
    the main pool).
    """

    scores: torch.Tensor  # f32[B, <=k]
    doc_ids: torch.Tensor  # i32[B, <=k] global doc ids
    main: Any  # SaatResult | DaatResult over the main segment
    delta: Tuple[torch.Tensor, torch.Tensor] | None  # delta (scores, gids) pool

    @property
    def stats(self):
        """Main-segment ``WorkStats`` (DAAT only, else ``None``): what the
        serving queue's survivor predictor reads."""
        return getattr(self.main, "stats", None)


def search_delta_pool(
    delta: ImpactIndex,
    q_terms,
    q_weights,
    *,
    k: int,
    engine: str = "saat",
    scatter_impl: str = "scatter",
    fused_topk: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k pool over a delta segment: ``(scores, local_ids)``.

    The delta is tiny, so both engines search it exhaustively: SAAT at its
    own ``exact_rho``; DAAT as a phase-1-only pass over every delta block
    (no pruning; selection order is ascending local id, the canonical
    merge's tie order).
    """
    if engine == "saat":
        res = saat.saat_search(
            delta, q_terms, q_weights, k=k, rho=saat.exact_rho(delta),
            max_segs_per_term=saat.max_segments_per_term(delta),
            scatter_impl=scatter_impl, fused_topk=fused_topk,
        )
        return res.scores, res.doc_ids
    q_terms, q_weights, _ = queries_on_device(delta, q_terms, q_weights)
    B = q_terms.shape[0]
    qvec = daat.query_vectors(delta, q_terms, q_weights)
    block_ids = torch.arange(delta.n_blocks, dtype=torch.int32, device=delta.device).expand(B, -1)
    s, d = daat.score_blocks(delta, qvec, block_ids)
    ds, dpos = topk(s.reshape(B, -1), k)
    dlocal = torch.gather(d.reshape(B, -1), -1, dpos)
    return ds, dlocal


class IndexHandle:
    """Mutable corpus facade: main segment + delta segment + tombstones.

    A host-side mutable object: mutations rebuild the small delta index
    synchronously; searches call the same engines as the immutable path.
    Global doc ids are stable forever: ``add`` assigns ``next_gid`` and ids
    are never re-used.
    """

    def __init__(self, main: ImpactIndex, *, quant_max_weight: float | None = None):
        if main.n_blocks * main.block_size != main.doc_terms.shape[0]:
            raise ValueError("main index doc-major store is not block-aligned")
        self.main = main
        self.generation = 0
        # the pinned quantization grid: every delta build and every
        # compaction quantizes onto main's grid
        self.quant_max_weight = (
            float(quant_max_weight)
            if quant_max_weight is not None
            else float(main.scale) * QuantConfig(bits=main.bits).levels
        )
        self._next_gid = main.n_docs
        self._dead: set[int] = set()
        # raw (terms, weights) per delta gid; the delta index is derived
        self._delta: dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._delta_index: ImpactIndex | None = None
        self._delta_gids: torch.Tensor | None = None
        self._live_np = np.zeros(main.doc_terms.shape[0], np.int32)
        self._live_np[: main.n_docs] = 1
        self._upload_live()

    # ------------------------------------------------------------------ build
    @classmethod
    def from_corpus(
        cls,
        doc_idx: np.ndarray,
        term_idx: np.ndarray,
        weights: np.ndarray,
        n_docs: int,
        n_terms: int,
        *,
        quant: QuantConfig = QuantConfig(bits=8),
        block_size: int = 128,
        quant_max_weight: float | None = None,
        device: str | torch.device | None = None,
        **build_kwargs,
    ) -> "IndexHandle":
        """Build the generation-0 handle from COO postings, on ``device``
        (``cuda`` unless the caller passes ``"cpu"``).

        For an empty corpus pass ``quant_max_weight`` explicitly: otherwise
        the grid pins to the empty build's default max weight of 1.0 and
        later heavier documents quantize clipped.
        """
        if quant.scheme != "uniform":
            raise ValueError("IndexHandle requires the uniform quantization scheme")
        main = build_impact_index(
            doc_idx, term_idx, weights, n_docs, n_terms,
            quant=quant, block_size=block_size,
            quant_max_weight=quant_max_weight, device=device, **build_kwargs,
        )
        return cls(main, quant_max_weight=quant_max_weight)

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.main.device

    @property
    def n_docs(self) -> int:
        """Size of the global doc-id space (monotone; includes dead gids)."""
        return self._next_gid

    @property
    def n_terms(self) -> int:
        return self.main.n_terms

    @property
    def live_mask(self) -> torch.Tensor:
        """i32[main n_docs_pad] tombstone bitmap the engines consume."""
        return self._live_dev

    @property
    def delta(self) -> ImpactIndex | None:
        """The delta segment index (``None`` when no docs are pending)."""
        return self._delta_index

    @property
    def delta_docs(self) -> int:
        return len(self._delta)

    @property
    def delta_gids(self) -> torch.Tensor | None:
        """Local-to-gid map of the delta segment (``None`` with no delta),
        padded to the delta's doc pad with gid 0: pad slots score ``-inf``
        and every finite candidate beats them in the merge."""
        return self._delta_gids

    @property
    def tombstone_count(self) -> int:
        return len(self._dead)

    @property
    def dead_gids(self) -> frozenset[int]:
        return frozenset(self._dead)

    def live_mask_full(self, pad_to: int | None = None) -> np.ndarray:
        """i32 live bitmap over the FULL gid space, the parity oracle's mask:
        live gids 1, tombstoned gids 0, pad slots (``>= n_docs``) 0."""
        n = self._next_gid
        mask = np.ones(max(pad_to or n, n), np.int32)
        mask[n:] = 0
        for gid in self._dead:
            mask[gid] = 0
        return mask

    # -------------------------------------------------------------- mutations
    def add(self, terms: np.ndarray, weights: np.ndarray) -> int:
        """Add a new document; returns its (stable, never re-used) gid."""
        gid = self._next_gid
        self._next_gid += 1
        self._set_delta_doc(gid, terms, weights)
        return gid

    def update(self, gid: int, terms: np.ndarray, weights: np.ndarray) -> None:
        """Replace a document's sparse vector in place (same gid): a
        main-resident doc is tombstoned in main and reborn in the delta, so
        a live doc appears in at most one pool."""
        if not 0 <= gid < self._next_gid:
            raise KeyError(f"gid {gid} was never allocated")
        self._dead.discard(gid)
        self._set_delta_doc(gid, terms, weights)

    def delete(self, gid: int) -> None:
        """Tombstone a document (idempotent; the gid is never re-used)."""
        if not 0 <= gid < self._next_gid:
            raise KeyError(f"gid {gid} was never allocated")
        self._dead.add(gid)
        dropped = self._delta.pop(gid, None)
        if gid < self.main.n_docs and self._live_np[gid]:
            self._live_np[gid] = 0
            self._upload_live()
        if dropped is not None:
            self._rebuild_delta()

    def _upload_live(self) -> None:
        # a copy: the host bitmap keeps changing under later mutations
        self._live_dev = torch.tensor(self._live_np, device=self.device)

    def _set_delta_doc(self, gid: int, terms: np.ndarray, weights: np.ndarray) -> None:
        terms = np.asarray(terms, dtype=np.int64).ravel()
        weights = np.asarray(weights, dtype=np.float64).ravel()
        if terms.shape != weights.shape:
            raise ValueError("terms/weights length mismatch")
        if terms.size and (terms.min() < 0 or terms.max() >= self.n_terms):
            raise ValueError("term id outside the handle's fixed vocabulary")
        keep = weights > 0
        self._delta[gid] = (terms[keep], weights[keep])
        if gid < self.main.n_docs and self._live_np[gid]:
            self._live_np[gid] = 0  # the delta copy supersedes the main copy
            self._upload_live()
        self._rebuild_delta()

    def _rebuild_delta(self) -> None:
        """Rebuild the delta segment from the raw pending docs, local ids in
        ascending-gid order (so the delta's tie order maps to gid order)."""
        if not self._delta:
            self._delta_index = None
            self._delta_gids = None
            return
        gids = sorted(self._delta)
        d, t, w = [], [], []
        for local, gid in enumerate(gids):
            terms, weights = self._delta[gid]
            d.append(np.full(terms.size, local, np.int64))
            t.append(terms)
            w.append(weights)
        self._delta_index = build_impact_index(
            np.concatenate(d), np.concatenate(t), np.concatenate(w),
            len(gids), self.n_terms,
            quant=QuantConfig(bits=self.main.bits),
            block_size=self.main.block_size,
            quant_max_weight=self.quant_max_weight,
            device=self.device,
        )
        gid_arr = np.zeros(self._delta_index.doc_terms.shape[0], np.int32)
        gid_arr[: len(gids)] = gids
        self._delta_gids = torch.tensor(gid_arr, device=self.device)

    # ------------------------------------------------------------- compaction
    def _grid_coo(
        self, index: ImpactIndex, live: np.ndarray | None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """COO of a segment with re-quantization-stable mid-step weights
        ``(q - 0.5) * scale`` (see the module docstring)."""
        d, t, w = extract_doc_coo(index, live)
        scale = self.quant_max_weight / QuantConfig(bits=index.bits).levels
        q = np.round(w / scale)
        return d, t, (q - 0.5) * scale

    def export_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Requantization-stable COO of the live MAIN segment (delta docs
        excluded: compact first)."""
        return self._grid_coo(self.main, self._live_np)

    def compact(self) -> None:
        """Fold main + delta - tombstones into a fresh main; bump generation.

        The fold and the build run on the host; the new main is then placed
        on the handle's device. Tombstoned gids stay dead, the delta
        empties, and the quantization grid is unchanged, so answers after
        the fold equal the answers before it.
        """
        parts = [self._grid_coo(self.main, self._live_np)]
        if self._delta_index is not None:
            gids = np.asarray(sorted(self._delta), np.int64)
            d, t, w = self._grid_coo(self._delta_index, None)
            parts.append((gids[d], t, w))
        d = np.concatenate([p[0] for p in parts])
        t = np.concatenate([p[1] for p in parts])
        w = np.concatenate([p[2] for p in parts])
        self.main = build_impact_index(
            d, t, w, self._next_gid, self.n_terms,
            quant=QuantConfig(bits=self.main.bits),
            block_size=self.main.block_size,
            quant_max_weight=self.quant_max_weight,
            device=self.device,
        )
        self._delta = {}
        self._delta_index = None
        self._delta_gids = None
        self._live_np = np.zeros(self.main.doc_terms.shape[0], np.int32)
        self._live_np[: self._next_gid] = 1
        for gid in self._dead:
            self._live_np[gid] = 0
        self._upload_live()
        self.generation += 1

    # ---------------------------------------------------------------- search
    def _merge_delta(self, main_scores, main_ids, delta_scores, delta_local_ids, k):
        gids = self._delta_gids[delta_local_ids.long()]
        scores, ids = merge_pools_by_id(main_scores, main_ids, delta_scores, gids, k)
        return scores, ids, (delta_scores, gids)

    def saat_search(
        self,
        q_terms,
        q_weights,
        *,
        k: int,
        rho: int | None = None,
        scatter_impl: str = "scatter",
        fused_topk: bool = False,
    ) -> HandleResult:
        """Anytime SAAT over the live corpus. ``rho`` budgets MAIN only; the
        tiny delta is always searched exactly. Tombstoned docs score
        ``-inf`` via the engine's ``live_mask``; pools merge by gid."""
        main = self.main
        res_m = saat.saat_search(
            main, q_terms, q_weights, k=k,
            rho=int(rho) if rho is not None else saat.exact_rho(main),
            max_segs_per_term=saat.max_segments_per_term(main),
            scatter_impl=scatter_impl, fused_topk=fused_topk,
            live_mask=self._live_dev,
        )
        if self._delta_index is None:
            return HandleResult(res_m.scores, res_m.doc_ids, res_m, None)
        ds, dlocal = search_delta_pool(
            self._delta_index, q_terms, q_weights, k=k, engine="saat",
            scatter_impl=scatter_impl, fused_topk=fused_topk,
        )
        scores, ids, pool = self._merge_delta(res_m.scores, res_m.doc_ids, ds, dlocal, k)
        return HandleResult(scores, ids, res_m, pool)

    def daat_search(
        self,
        q_terms,
        q_weights,
        *,
        k: int,
        est_blocks: int,
        block_budget: int,
        exact: bool = True,
        max_chunks: int | None = None,
        use_kernels: bool = False,
        fused_chunk: bool = False,
        trips_per_launch: int = 1,
    ) -> HandleResult:
        """Block-max DAAT over the live corpus; skipping applies to MAIN only,
        the delta is scored exhaustively. Fully dead main blocks leave
        selection via the engine's ``live_mask``."""
        main = self.main
        res_m = daat.daat_search_batched(
            main, q_terms, q_weights, k=k, est_blocks=est_blocks,
            block_budget=block_budget,
            max_bm_per_term=daat.max_blocks_per_term(main),
            exact=exact, max_chunks=max_chunks, use_kernels=use_kernels,
            fused_chunk=fused_chunk, trips_per_launch=trips_per_launch,
            live_mask=self._live_dev,
        )
        if self._delta_index is None:
            return HandleResult(res_m.scores, res_m.doc_ids, res_m, None)
        ds, dlocal = search_delta_pool(self._delta_index, q_terms, q_weights, k=k, engine="daat")
        scores, ids, pool = self._merge_delta(res_m.scores, res_m.doc_ids, ds, dlocal, k)
        return HandleResult(scores, ids, res_m, pool)
