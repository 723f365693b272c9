"""Step plans: (arch x shape x mesh) -> (fn, abstract args, shardings),
the port of ``repro.launch.steps``.

The one place that knows how to turn an ArchSpec cell into the step the
production job runs: shared by the dry-run and the tests. ``args`` are
tensors on the ``meta`` device (shapes and dtypes, no allocation): the
train state of ``abstract_train_state`` (its params the family's module),
the batch of ``batch_specs``, the LM's ``abstract_cache``. ``fn`` is the
port's step on such args once they hold values; ``in_shardings`` is the
tree of the port's ``NamedSharding``s mirroring ``args`` (a module's params
and moments as dicts keyed by parameter name).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ArchSpec, Cell, batch_specs
from repro_torch.distributed.sharding import (
    Mesh,
    NamedSharding,
    P,
    batch_dim_sharding,
    cache_shardings,
    fully_sharded_dim,
    mesh_axes,
    param_shardings,
    train_state_shardings,
)
from repro_torch.train.optim import AdamWConfig
from repro_torch.train.trainer import abstract_train_state, make_train_step
from repro_torch.train.tree import tree_map


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape_name: str
    kind: str
    fn: Callable
    args: tuple  # meta tensors (shapes and dtypes), or real tensors in tests
    in_shardings: tuple
    model_flops: float
    static_meta: dict


def _dp_size(mesh: Mesh) -> int:
    ax = mesh_axes(mesh)
    n = 1
    for a in ax.data:
        n *= mesh.shape[a]
    return n


def _maybe_batch_sharding(mesh: Mesh, leaf, *, fully: bool = False):
    """Shard the leading dim if divisible by the axis group; degrade
    all-axes -> data-axes -> replicated."""
    ax = mesh_axes(mesh)

    def group_size(group):
        n = 1
        for a in group:
            n *= mesh.shape[a]
        return n

    extra = max(len(leaf.shape) - 1, 0)
    if fully and leaf.shape and leaf.shape[0] % group_size(ax.all) == 0:
        return fully_sharded_dim(mesh, extra)
    if leaf.shape and leaf.shape[0] % group_size(ax.data) == 0:
        return batch_dim_sharding(mesh, extra)
    return NamedSharding(mesh, P())


def _batch_shardings(batch, mesh: Mesh, *, fully: bool = False):
    return tree_map(lambda l: _maybe_batch_sharding(mesh, l, fully=fully), batch)


# --------------------------------------------------------------------------
# per-family plans
# --------------------------------------------------------------------------


def _lm_plan(spec: ArchSpec, cell: Cell, mesh: Mesh, opt_cfg: AdamWConfig) -> CellPlan:
    from repro_torch.archs import transformer as T

    cfg = spec.config_for(cell.name)
    aparams = T.abstract_lm_params(cfg)
    B, S = cell.dims["global_batch"], cell.dims["seq_len"]
    batch = batch_specs(spec, cell.name)

    if cell.kind == "train":
        state = abstract_train_state(aparams)
        st_sh = train_state_shardings(state, "lm", mesh)
        loss_fn = lambda p, b: T.lm_loss(p, b["tokens"], b["labels"], cfg)
        step = make_train_step(loss_fn, opt_cfg)
        args = (state, batch)
        in_sh = (st_sh, _batch_shardings(batch, mesh, fully=cfg.dp_layout))
        flops = T.train_step_model_flops(cfg, B, S)
    elif cell.kind == "prefill":
        step = lambda p, b: T.lm_prefill(p, b["tokens"], cfg)
        args = (aparams, batch)
        in_sh = (param_shardings(aparams, "lm", mesh), _batch_shardings(batch, mesh))
        flops = T.train_step_model_flops(cfg, B, S) / 3.0  # fwd only
    elif cell.kind == "decode":
        cache = batch["cache"]
        step = lambda p, c, t, pos: T.lm_decode_step(p, c, t, pos, cfg)
        args = (aparams, cache, batch["tokens"], batch["pos"])
        in_sh = (
            param_shardings(aparams, "lm", mesh),
            cache_shardings(cache, mesh),
            _maybe_batch_sharding(mesh, batch["tokens"]),
            _maybe_batch_sharding(mesh, batch["pos"]),
        )
        flops = T.decode_step_model_flops(cfg, B, S)
    else:
        raise ValueError(cell.kind)
    return CellPlan(
        arch_id=spec.arch_id,
        shape_name=cell.name,
        kind=cell.kind,
        fn=step,
        args=args,
        in_shardings=in_sh,
        model_flops=flops,
        static_meta={
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params(),
            "global_batch": B,
            "seq_len": S,
        },
    )


def _gnn_plan(spec: ArchSpec, cell: Cell, mesh: Mesh, opt_cfg: AdamWConfig) -> CellPlan:
    from repro_torch.archs import gnn as G

    cfg = spec.config_for(cell.name)
    aparams = G.abstract_gnn_params(cfg)
    batch = batch_specs(spec, cell.name)
    state = abstract_train_state(aparams)
    st_sh = train_state_shardings(state, "gnn", mesh)
    loss_fn = lambda p, b: G.gnn_loss(p, b, cfg)
    step = make_train_step(loss_fn, opt_cfg)
    n_nodes = batch["node_feats"].shape[0]
    n_edges = batch["edge_src"].shape[0]
    return CellPlan(
        arch_id=spec.arch_id,
        shape_name=cell.name,
        kind="train",
        fn=step,
        args=(state, batch),
        in_shardings=(st_sh, _batch_shardings(batch, mesh, fully=True)),
        model_flops=G.train_step_model_flops(cfg, n_nodes, n_edges),
        static_meta={"n_params": cfg.n_params(), "n_nodes": n_nodes, "n_edges": n_edges},
    )


def _recsys_plan(spec: ArchSpec, cell: Cell, mesh: Mesh, opt_cfg: AdamWConfig) -> CellPlan:
    from repro_torch.archs import recsys as R

    cfg = spec.config_for(cell.name)
    aparams = R.abstract_params(cfg)
    batch = batch_specs(spec, cell.name)
    B = cell.dims["batch"]

    if cell.kind == "train":
        state = abstract_train_state(aparams)
        st_sh = train_state_shardings(state, "recsys", mesh)
        loss_fn = lambda p, b: R.loss(p, b, cfg)
        step = make_train_step(loss_fn, opt_cfg)
        args = (state, batch)
        in_sh = (st_sh, _batch_shardings(batch, mesh))
        flops = R.train_step_model_flops(cfg, B)
    elif cell.kind == "serve":
        step = lambda p, b: R.forward(p, b, cfg)
        args = (aparams, batch)
        in_sh = (param_shardings(aparams, "recsys", mesh), _batch_shardings(batch, mesh))
        flops = R.train_step_model_flops(cfg, B) / 3.0
    elif cell.kind == "retrieval":
        n_cand = cell.dims["n_candidates"]
        step = lambda p, b: R.retrieve_topk(p, b, cfg, k=100, num_tiles=64)
        args = (aparams, batch)
        # user-side features replicated (batch=1); candidates over all axes
        cand_sh = {
            k: (_maybe_batch_sharding(mesh, v, fully=True) if k == "candidates"
                else NamedSharding(mesh, P()))
            for k, v in batch.items()
        }
        in_sh = (param_shardings(aparams, "recsys", mesh), cand_sh)
        flops = R.train_step_model_flops(cfg, n_cand) / 3.0
    else:
        raise ValueError(cell.kind)
    return CellPlan(
        arch_id=spec.arch_id,
        shape_name=cell.name,
        kind=cell.kind,
        fn=step,
        args=args,
        in_shardings=in_sh,
        model_flops=flops,
        static_meta={"n_params": cfg.n_params(), "batch": B},
    )


def build_cell_plan(
    spec: ArchSpec, shape_name: str, mesh: Mesh, opt_cfg: Optional[AdamWConfig] = None
) -> CellPlan:
    cell = spec.cells[shape_name]
    if cell.skip is not None:
        raise ValueError(f"cell {spec.arch_id}/{shape_name} is skipped: {cell.skip}")
    opt_cfg = opt_cfg or AdamWConfig()
    plan = {"lm": _lm_plan, "gnn": _gnn_plan, "recsys": _recsys_plan}[spec.family]
    return plan(spec, cell, mesh, opt_cfg)
