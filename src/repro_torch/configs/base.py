"""Arch/shape registry scaffolding.

Every assigned architecture ships one module defining ``SPEC: ArchSpec``:
  * ``config_for(shape)`` — the exact published config, tuned per shape only
    in *execution* knobs (attn chunking, vocab-chunked loss, seq sharding),
    never in model math;
  * ``smoke_config()`` — a reduced same-family config for CPU smoke tests;
  * ``cells`` — the assigned input shapes, each mapping to a step kind:
        train      train_step(state, batch)          (LM / GNN / recsys)
        prefill    prefill(params, tokens)           (LM)
        decode     decode_step(params, cache, t, pos)(LM)
        serve      forward(params, batch)            (recsys online/bulk)
        retrieval  retrieve_topk(params, batch)      (recsys 1 x 1M)
    Cells may be marked ``skip`` with a documented reason (DESIGN.md
    §Arch-applicability) — they count as cells but are not lowered.

``batch_specs(spec, shape)`` returns stand-ins for every model input:
tensors on the ``meta`` device (shapes and dtypes, no allocation), where the
reference returns ``ShapeDtypeStruct``s. The port of
``repro.configs.base``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


def sds(shape, dtype) -> torch.Tensor:
    """A tensor on the ``meta`` device: the shape and dtype of an input."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    dims: dict
    skip: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys
    source: str
    config_for: Callable[[str], Any]
    smoke_config: Callable[[], Any]
    cells: dict

    def runnable_cells(self) -> list:
        return [c for c in self.cells.values() if c.skip is None]


# --------------------------------------------------------------------------
# shared shape tables (the assignment's per-family shape sets)
# --------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256),
    "prefill_32k": dict(seq_len=32768, global_batch=32),
    "decode_32k": dict(seq_len=32768, global_batch=128),
    "long_500k": dict(seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433),
    "minibatch_lg": dict(
        n_nodes=232965, n_edges=114615892, batch_nodes=1024, fanout=(15, 10), d_feat=602
    ),
    "ogb_products": dict(n_nodes=2449029, n_edges=61859140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32),
}

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


def lm_cells(*, long_ok: bool, long_skip_reason: str = "") -> dict:
    kinds = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode", "long_500k": "decode"}
    cells = {}
    for name, dims in LM_SHAPES.items():
        skip = None
        if name == "long_500k" and not long_ok:
            skip = long_skip_reason
        cells[name] = Cell(name=name, kind=kinds[name], dims=dims, skip=skip)
    return cells


def gnn_cells() -> dict:
    return {n: Cell(name=n, kind="train", dims=d) for n, d in GNN_SHAPES.items()}


def recsys_cells() -> dict:
    kinds = {
        "train_batch": "train",
        "serve_p99": "serve",
        "serve_bulk": "serve",
        "retrieval_cand": "retrieval",
    }
    return {n: Cell(name=n, kind=kinds[n], dims=d) for n, d in RECSYS_SHAPES.items()}


# --------------------------------------------------------------------------
# batch ShapeDtypeStructs per family/kind
# --------------------------------------------------------------------------


def lm_batch_specs(cell: Cell, cfg) -> dict:
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    if cell.kind == "train":
        return {"tokens": sds((B, S), torch.int32), "labels": sds((B, S), torch.int32)}
    if cell.kind == "prefill":
        return {"tokens": sds((B, S), torch.int32)}
    if cell.kind == "decode":
        from repro_torch.archs.transformer import CacheSpec, abstract_cache

        cache = abstract_cache(CacheSpec(cfg, B, S))
        return {
            "tokens": sds((B, 1), torch.int32),
            "pos": sds((B,), torch.int32),
            "cache": cache,
        }
    raise ValueError(cell.kind)


def _pad512(n: int) -> int:
    """Graph arrays pad to 512-aligned sizes (masked) so node/edge axes can
    shard evenly on the 256/512-chip meshes — the assigned raw sizes (e.g.
    ogb_products' 2,449,029 nodes) divide nothing."""
    return (n + 511) // 512 * 512


def gnn_batch_specs(cell: Cell, cfg) -> dict:
    d = cell.dims
    if cell.name == "minibatch_lg":
        from repro_torch.data.graphs import sampling_budget

        n_pad, e_pad = sampling_budget(d["batch_nodes"], d["fanout"])
        out = {
            "node_feats": sds((n_pad, d["d_feat"]), torch.float32),
            "edge_src": sds((e_pad,), torch.int32),
            "edge_dst": sds((e_pad,), torch.int32),
            "edge_feats": sds((e_pad, cfg.d_edge_feat), torch.float32),
            "edge_mask": sds((e_pad,), torch.bool),
            "node_mask": sds((n_pad,), torch.float32),
            "targets": sds((n_pad, cfg.n_vars), torch.float32),
        }
        return out
    if cell.name == "molecule":
        N = _pad512(d["batch"] * d["n_nodes"])
        E = _pad512(d["batch"] * d["n_edges"])
        return {
            "node_feats": sds((N, d["d_feat"]), torch.float32),
            "edge_src": sds((E,), torch.int32),
            "edge_dst": sds((E,), torch.int32),
            "edge_feats": sds((E, cfg.d_edge_feat), torch.float32),
            "edge_mask": sds((E,), torch.bool),
            "graph_ids": sds((N,), torch.int32),
            "targets": sds((d["batch"], cfg.n_vars), torch.float32),
        }
    N, E = _pad512(d["n_nodes"]), _pad512(d["n_edges"])
    return {
        "node_feats": sds((N, d["d_feat"]), torch.float32),
        "edge_src": sds((E,), torch.int32),
        "edge_dst": sds((E,), torch.int32),
        "edge_feats": sds((E, cfg.d_edge_feat), torch.float32),
        "edge_mask": sds((E,), torch.bool),
        "node_mask": sds((N,), torch.float32),
        "targets": sds((N, cfg.n_vars), torch.float32),
    }


def recsys_batch_specs(cell: Cell, cfg) -> dict:
    B = cell.dims["batch"]
    kind = cfg.kind
    if kind == "dcn-v2":
        base = {
            "dense": sds((B, cfg.n_dense), torch.float32),
            "sparse": sds((B, cfg.table.n_slots), torch.int32),
        }
    elif kind == "din":
        base = {
            "hist": sds((B, cfg.seq_len), torch.int32),
            "hist_mask": sds((B, cfg.seq_len), torch.bool),
            "target": sds((B,), torch.int32),
        }
    elif kind == "sasrec":
        base = {
            "seq": sds((B, cfg.seq_len), torch.int32),
            "mask": sds((B, cfg.seq_len), torch.bool),
            "pos": sds((B, cfg.seq_len), torch.int32),
            "neg": sds((B, cfg.seq_len), torch.int32),
        }
    elif kind == "wide-deep":
        base = {"sparse": sds((B, cfg.table.n_slots), torch.int32)}
    else:
        raise ValueError(kind)
    if cell.kind == "train":
        base["label"] = sds((B,), torch.float32)
    if cell.kind == "retrieval":
        # pad 1,000,000 -> 512-aligned (1,000,448): the candidate axis then
        # shards over all 256/512 chips instead of the 16 data ranks
        # (1M % 256 != 0); padded slots repeat candidate 0, dropped post-topk
        n_cand = -(-cell.dims["n_candidates"] // 512) * 512
        base["candidates"] = sds((n_cand,), torch.int32)
        base.pop("label", None)
        # retrieval uses user-side features only; sasrec/din drop pos/neg/target
        if kind == "sasrec":
            base.pop("pos"), base.pop("neg")
        if kind == "din":
            base.pop("target")
    return base


def batch_specs(spec: ArchSpec, shape_name: str) -> dict:
    cell = spec.cells[shape_name]
    cfg = spec.config_for(shape_name)
    return {"lm": lm_batch_specs, "gnn": gnn_batch_specs, "recsys": recsys_batch_specs}[
        spec.family
    ](cell, cfg)
