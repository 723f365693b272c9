"""GraphCast-style encode-process-decode GNN: the port of
``repro.archs.gnn``.

Message passing on an edge-index representation: per-edge gathers and
per-node scatters (``index_add_`` for ``jax.ops.segment_sum``,
``scatter_reduce("amax")`` from a ``-inf`` fill for ``segment_max``, so an
empty segment is ``-inf`` as in the reference). The same segment machinery
backs the recsys ``embedding_bag``.

Model: encoder (node/edge feature MLPs into d_hidden), ``n_layers``
InteractionNetwork processor blocks (edge update from [edge, src, dst] ->
aggregate to nodes -> node update, both residual), decoder (node MLP to
``n_vars`` outputs). The model is a ``GNN`` module holding the reference's
pytree as a ``ParamTree``, but for the processor: the reference's stacked
``[L, ...]`` ``proc`` leaves are an ``nn.ModuleList`` of blocks here
(``proc.3.edge.w1``), walked in a loop; ``remat="full"`` checkpoints each
block (``torch.utils.checkpoint``, ``use_reentrant=False``).
``gnn_params_from_reference`` and ``gnn_params_to_reference`` carry the
stacked pytree to a ``state_dict`` and back.

On the card ``index_add_`` adds with atomics, so a bf16 aggregate's bits
depend on the order of the adds; the reference's order is the CPU's.

Graphs are static-shape: ``(node_feats[N, F], edge_src[E], edge_dst[E],
node_mask[N], edge_mask[E])`` with padding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.archs import layers
from repro_torch.archs.transformer import model_device
from repro_torch.train.tree import dotted_names, nest_names, tree_map


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 16
    d_hidden: int = 512
    aggregator: str = "sum"  # sum | mean | max
    n_vars: int = 227  # output dim per node (GraphCast: weather variables)
    d_feat: int = 227  # input node feature dim (per shape)
    d_edge_feat: int = 4  # input edge feature dim (e.g. displacement vectors)
    mesh_refinement: int = 6  # the weather example's mesh refinement level
    graph_readout: bool = False  # molecule shape: per-graph output
    remat: str = "full"
    dtype: object = torch.float32

    def n_params(self) -> int:
        h = self.d_hidden
        enc = self.d_feat * h + h + self.d_edge_feat * h + h
        proc = self.n_layers * ((3 * h) * h + h + h * h + h + (2 * h) * h + h + h * h + h)
        dec = h * self.n_vars + self.n_vars
        return enc + proc + dec


def _mlp2_params(gen, d_in: int, d_hidden: int, d_out: int, dtype, device):
    return {
        "w1": layers.dense_init(gen, d_in, d_hidden, dtype, device=device),
        "b1": torch.zeros((d_hidden,), dtype=dtype, device=device),
        "w2": layers.dense_init(gen, d_hidden, d_out, dtype, device=device),
        "b2": torch.zeros((d_out,), dtype=dtype, device=device),
    }


def _mlp2(p, x):
    return F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class GNN(layers.ParamTree):
    """``enc_node``, ``enc_edge``, ``proc`` (a list of ``{edge, node}``
    blocks) and ``dec``, each MLP's ``w1, b1, w2, b2``."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator | None = None, device=None):
        device = model_device(device)
        h = cfg.d_hidden
        super().__init__({
            "enc_node": _mlp2_params(gen, cfg.d_feat, h, h, cfg.dtype, device),
            "enc_edge": _mlp2_params(gen, cfg.d_edge_feat, h, h, cfg.dtype, device),
            "proc": [{"edge": _mlp2_params(gen, 3 * h, h, h, cfg.dtype, device),
                      "node": _mlp2_params(gen, 2 * h, h, h, cfg.dtype, device)}
                     for _ in range(cfg.n_layers)],
            "dec": _mlp2_params(gen, h, h, cfg.n_vars, cfg.dtype, device),
        })
        self.cfg = cfg

    def reference_tree(self, named: dict) -> dict:
        """name -> tensor (the params, or a moment keyed as the params) ->
        the reference's param pytree, ``proc`` stacked (checkpoints)."""
        return gnn_params_to_reference(named)

    def from_reference_tree(self, tree) -> dict:
        return gnn_params_from_reference(tree)


def init_gnn_params(gen: torch.Generator | None, cfg: GNNConfig, device=None) -> GNN:
    """A ``GNN`` drawn from ``gen`` (on the host, or on a CUDA generator's
    card) on ``device`` (``cuda`` unless ``"cpu"``; ``"meta"``: shapes
    only)."""
    return GNN(cfg, gen, device)


def abstract_gnn_params(cfg: GNNConfig) -> GNN:
    return GNN(cfg, None, "meta")


def gnn_params_from_reference(tree) -> dict:
    """The reference's ``init_gnn_params`` pytree (numpy arrays or tensors;
    ``proc`` leaves ``[L, ...]``) -> the port's ``state_dict``."""
    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    out = {name: t(leaf) for key in ("enc_node", "enc_edge", "dec")
           for name, leaf in dotted_names({key: tree[key]}).items()}
    for name, leaf in dotted_names(tree["proc"]).items():
        leaf = t(leaf)
        for i in range(leaf.shape[0]):
            out[f"proc.{i}.{name}"] = leaf[i]
    return out


def gnn_params_to_reference(named: dict) -> dict:
    """The inverse of ``gnn_params_from_reference``."""
    tree = nest_names(named)
    tree["proc"] = tree_map(lambda *xs: torch.stack(xs), *tree["proc"])
    return tree


def _aggregate(cfg: GNNConfig, msgs: torch.Tensor, dst: torch.Tensor,
               n_nodes: int) -> torch.Tensor:
    idx = dst.long()
    if cfg.aggregator == "sum":
        return msgs.new_zeros((n_nodes, msgs.shape[1])).index_add(0, idx, msgs)
    if cfg.aggregator == "mean":
        s = msgs.new_zeros((n_nodes, msgs.shape[1])).index_add(0, idx, msgs)
        c = msgs.new_zeros((n_nodes, 1)).index_add(0, idx, msgs.new_ones((msgs.shape[0], 1)))
        return s / torch.clamp(c, min=1.0)
    if cfg.aggregator == "max":
        # an empty segment is -inf, as segment_max's; a tied maximum's
        # gradient is shared among the ties, as jax.grad shares it
        out = msgs.new_full((n_nodes, msgs.shape[1]), -torch.inf)
        return out.scatter_reduce(0, idx[:, None].expand_as(msgs), msgs, "amax",
                                  include_self=True)
    raise ValueError(cfg.aggregator)


def gnn_forward(
    params,
    node_feats: torch.Tensor,  # f32[N, F]
    edge_src: torch.Tensor,  # i32[E]
    edge_dst: torch.Tensor,  # i32[E]
    cfg: GNNConfig,
    *,
    edge_feats: Optional[torch.Tensor] = None,  # f32[E, Fe]
    edge_mask: Optional[torch.Tensor] = None,  # bool[E] (padding)
    graph_ids: Optional[torch.Tensor] = None,  # i32[N] for graph readout
    n_graphs: int = 0,
) -> torch.Tensor:
    """Node outputs ``[N, n_vars]`` (or graph outputs ``[n_graphs, n_vars]``)."""
    p = params.tree() if isinstance(params, layers.ParamTree) else params
    N = node_feats.shape[0]
    E = edge_src.shape[0]
    h = _mlp2(p["enc_node"], node_feats.to(cfg.dtype))
    if edge_feats is None:
        edge_feats = torch.zeros((E, cfg.d_edge_feat), dtype=cfg.dtype, device=node_feats.device)
    e = _mlp2(p["enc_edge"], edge_feats.to(cfg.dtype))
    if edge_mask is not None:
        e = torch.where(edge_mask[:, None], e, 0.0)
        # padded edges point at node 0; zero messages keep them inert
        edge_src = torch.where(edge_mask, edge_src, 0)
        edge_dst = torch.where(edge_mask, edge_dst, 0)
    src, dst = edge_src.long(), edge_dst.long()

    def inner(h, e, block_p):
        he_src = h[src]
        he_dst = h[dst]
        e_new = e + _mlp2(block_p["edge"], torch.cat([e, he_src, he_dst], dim=-1))
        if edge_mask is not None:
            e_new = torch.where(edge_mask[:, None], e_new, 0.0)
        agg = _aggregate(cfg, e_new, dst, N)
        h_new = h + _mlp2(block_p["node"], torch.cat([h, agg], dim=-1))
        return h_new, e_new

    for block_p in p["proc"]:
        if cfg.remat == "none":
            h, e = inner(h, e, block_p)
        else:
            h, e = checkpoint(inner, h, e, block_p, use_reentrant=False)
    if cfg.graph_readout:
        if graph_ids is None or n_graphs <= 0:
            raise ValueError("graph readout needs graph_ids and n_graphs > 0")
        pooled = h.new_zeros((n_graphs, h.shape[1])).index_add(0, graph_ids.long(), h)
        return _mlp2(p["dec"], pooled)
    return _mlp2(p["dec"], h)


def gnn_loss(params, batch, cfg: GNNConfig):
    """MSE regression loss (GraphCast trains on per-variable weather MSE)."""
    out = gnn_forward(
        params,
        batch["node_feats"],
        batch["edge_src"],
        batch["edge_dst"],
        cfg,
        edge_feats=batch.get("edge_feats"),
        edge_mask=batch.get("edge_mask"),
        graph_ids=batch.get("graph_ids"),
        n_graphs=int(batch["targets"].shape[0]) if cfg.graph_readout else 0,
    )
    tgt = batch["targets"].float()
    err = (out.float() - tgt) ** 2
    mask = batch.get("node_mask")
    if mask is not None and not cfg.graph_readout:
        err = err * mask[:, None]
        denom = torch.clamp(mask.sum() * cfg.n_vars, min=1.0)
    else:
        denom = float(err.numel())
    loss = err.sum() / denom
    return loss, {"mse": loss}


def train_step_model_flops(cfg: GNNConfig, n_nodes: int, n_edges: int) -> float:
    """Useful FLOPs for one fwd+bwd step: 6 * (per-entity matmul work)."""
    h = cfg.d_hidden
    enc = n_nodes * cfg.d_feat * h + n_nodes * h * h + n_edges * cfg.d_edge_feat * h + n_edges * h * h
    per_layer = n_edges * (3 * h) * h + n_edges * h * h + n_nodes * (2 * h) * h + n_nodes * h * h
    dec = n_nodes * h * h + n_nodes * h * cfg.n_vars
    return 6.0 * (enc + cfg.n_layers * per_layer + dec)


# --------------------------------------------------------------------------
# the weather mesh (mesh_refinement), host side
# --------------------------------------------------------------------------


def build_refined_mesh(refinement: int) -> tuple:
    """Icosahedral-style refined mesh (numpy, host side).

    Returns ``(n_nodes, edge_src, edge_dst)`` of the multilevel mesh graph.
    Node count follows 10 * 4^r + 2; edges connect each node to its ~6
    neighbors at the finest level plus coarse long-range edges — matching the
    connectivity *statistics* GraphCast's processor sees (the exact spherical
    geometry is irrelevant to the systems behaviour).
    """
    n = 10 * (4**refinement) + 2
    rng = np.random.default_rng(refinement)
    # 6-regular ring lattice + random long-range (coarse-level) shortcuts
    base = np.arange(n, dtype=np.int64)
    src, dst = [], []
    for d in (1, 2, 3):
        src.append(base)
        dst.append((base + d) % n)
    n_long = n // 2
    src.append(rng.integers(0, n, n_long))
    dst.append(rng.integers(0, n, n_long))
    s = np.concatenate(src)
    t = np.concatenate(dst)
    # symmetrize
    es = np.concatenate([s, t]).astype(np.int32)
    ed = np.concatenate([t, s]).astype(np.int32)
    return n, es, ed
