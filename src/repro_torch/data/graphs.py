"""Graph data substrate: synthetic graphs + a real fanout neighbor sampler.
A copy of ``repro.data.graphs`` (numpy only).

``minibatch_lg`` requires genuine GraphSAGE-style neighbor sampling: seed
nodes -> sample ``fanout[0]`` in-neighbors -> ``fanout[1]`` of theirs, build
the induced bipartite subgraph with *local* node ids, pad to static shapes.
The sampler is host-side numpy over a CSR adjacency (the standard
input-pipeline placement: sampling is data prep, message passing is device
work).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """In-neighbor CSR: predecessors of node v are col[ptr[v]:ptr[v+1]]."""

    ptr: np.ndarray  # i64[N+1]
    col: np.ndarray  # i32[E]
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.col.shape[0])


def edges_to_csr(edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int) -> CSRGraph:
    order = np.argsort(edge_dst, kind="stable")
    src, dst = edge_src[order].astype(np.int32), edge_dst[order]
    ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    counts = np.bincount(dst, minlength=n_nodes)
    ptr[1:] = np.cumsum(counts)
    return CSRGraph(ptr=ptr, col=src, n_nodes=n_nodes)


def random_power_law_graph(n_nodes: int, n_edges: int, seed: int = 0, alpha: float = 1.3):
    """Synthetic scale-free-ish graph (host side)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.power(np.arange(1, n_nodes + 1, dtype=np.float64), alpha)
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    return src, dst


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Static-shape padded subgraph (device-ready)."""

    node_ids: np.ndarray  # i32[N_pad] global ids (padding = 0)
    node_mask: np.ndarray  # bool[N_pad]
    edge_src: np.ndarray  # i32[E_pad] local ids
    edge_dst: np.ndarray  # i32[E_pad] local ids
    edge_mask: np.ndarray  # bool[E_pad]
    n_seeds: int  # seeds occupy local ids [0, n_seeds)


def sample_neighbors(
    g: CSRGraph,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    *,
    rng: np.random.Generator,
    pad_nodes: int,
    pad_edges: int,
) -> SampledSubgraph:
    """Multi-hop fanout sampling with replacement-free per-node draws."""
    frontier = np.asarray(seeds, dtype=np.int32)
    # local id assignment: seeds first (stable order for the loss)
    local: dict[int, int] = {int(v): i for i, v in enumerate(frontier)}
    nodes: list[int] = list(map(int, frontier))
    e_src: list[int] = []
    e_dst: list[int] = []
    for fanout in fanouts:
        next_frontier: list[int] = []
        for v in frontier:
            lo, hi = g.ptr[v], g.ptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, int(deg))
            picks = rng.choice(deg, size=take, replace=False) + lo
            for u in g.col[picks]:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    next_frontier.append(u)
                e_src.append(local[u])
                e_dst.append(local[int(v)])
        frontier = np.asarray(next_frontier, dtype=np.int32)
        if frontier.size == 0:
            break
    n, e = len(nodes), len(e_src)
    if n > pad_nodes or e > pad_edges:
        raise ValueError(f"sample exceeds padding: nodes {n}>{pad_nodes} or edges {e}>{pad_edges}")
    node_ids = np.zeros(pad_nodes, dtype=np.int32)
    node_ids[:n] = nodes
    node_mask = np.zeros(pad_nodes, dtype=bool)
    node_mask[:n] = True
    es = np.zeros(pad_edges, dtype=np.int32)
    ed = np.zeros(pad_edges, dtype=np.int32)
    es[:e] = e_src
    ed[:e] = e_dst
    em = np.zeros(pad_edges, dtype=bool)
    em[:e] = True
    return SampledSubgraph(node_ids, node_mask, es, ed, em, n_seeds=len(seeds))


def sampling_budget(batch_nodes: int, fanouts: Sequence[int]) -> tuple[int, int]:
    """Static (pad_nodes, pad_edges) bounds for a fanout schedule."""
    nodes = batch_nodes
    frontier = batch_nodes
    edges = 0
    for f in fanouts:
        new = frontier * f
        edges += new
        nodes += new
        frontier = new
    return nodes, edges


def block_diagonal_batch(
    n_graphs: int, nodes_per_graph: int, edges_per_graph: int, d_feat: int, seed: int = 0
):
    """Batch many small graphs as one block-diagonal graph (molecule shape)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per_graph
    E = n_graphs * edges_per_graph
    offs = np.repeat(np.arange(n_graphs) * nodes_per_graph, edges_per_graph)
    src = rng.integers(0, nodes_per_graph, E).astype(np.int32) + offs
    dst = rng.integers(0, nodes_per_graph, E).astype(np.int32) + offs
    graph_ids = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per_graph)
    feats = rng.normal(size=(N, d_feat)).astype(np.float32)
    return feats, src.astype(np.int32), dst.astype(np.int32), graph_ids
