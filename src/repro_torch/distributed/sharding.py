"""Per-arch partition rules (DP / TP / EP / sequence / doc sharding), the
port of ``repro.distributed.sharding``.

One rule table maps param-leaf paths to logical layouts; logical layouts map
to mesh axes for whichever mesh is in play, so the same model code serves
the single-pod ``(data=16, model=16)`` and the multi-pod
``(pod=2, data=16, model=16)`` meshes (the ``pod`` axis joins the
data-parallel group). The tables and the rule functions are the
reference's, verbatim; see its docstring for the layout conventions.

The reference runs one SPMD program over a ``jax.sharding.Mesh``. The port
has no SPMD partitioner: its :class:`Mesh` is a small frozen description
(axis names, their sizes and the device the ranks run on), a
:class:`PartitionSpec` names the mesh axes each dim is split over, and a
:class:`NamedSharding` says which block of a tensor each rank holds. Ranks
run either all in this process, one after another in the flat rank order,
or one rank a process over a ``torch.distributed`` process group
(``place_tree``; ``repro_torch.serving.sharded``).

The flat rank order is row-major over ``mesh_axes(mesh).all``, the data
axes (``"pod"`` folded in) then ``"model"``: rank ``drank * n_model +
mrank``, the order in which the reference's partition specs lay out the
stacked shard axis and its tiled all-gathers concatenate. A dim split over
a tuple of axes, such as ``("pod", "data")``, is split major to minor in
that order, as JAX's ``devices_indices_map`` splits it.

The port's LM keeps one tensor a layer where the reference stacks each
block's layers on a leading axis, and the FSDP size guard
(``FSDP_MIN_BYTES``) reads the size of the reference's stacked leaf. So a
module's specs are computed on its params in the reference's layout (its
``reference_tree``) and handed to each of its own parameters with the
leading stack axes dropped (``param_specs``).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.train.tree import flatten_with_paths, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class Axes:
    """Resolved mesh axis names."""

    data: tuple[str, ...]  # all data-parallel axes ("pod" folds in here)
    model: str = "model"

    @property
    def all(self) -> tuple[str, ...]:
        return self.data + (self.model,)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes of ranks, and the device they run on."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis names {self.axis_names}")
        if any(int(n) < 1 for n in self.axis_sizes):
            raise ValueError(f"mesh axis sizes must be positive, got {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(int(s) for s in self.axis_sizes)


def make_mesh(axis_shapes, axis_names, *, device: str | torch.device | None = None) -> Mesh:
    """``jax.make_mesh``'s counterpart: ``device=None`` means the current
    CUDA device (and raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(axis_names), tuple(int(n) for n in axis_shapes), dev)


def mesh_axes(mesh: Mesh) -> Axes:
    names = mesh.axis_names
    data = tuple(n for n in names if n != "model")
    return Axes(data=data)


# --------------------------------------------------------------------------
# partition specs and shardings
# --------------------------------------------------------------------------


class PartitionSpec:
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a leading dim
    of a tensor, each ``None`` (not split), an axis name, or a tuple of axis
    names (split over their product, major to minor); dims past the entries
    are not split. ``P()`` is replicated. Equal to a tuple of the same
    entries. Not a tuple itself, so that a tree of specs
    (``repro_torch.train.tree``) has the specs as its leaves."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = parts

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self._parts == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_position(mesh: Mesh, axes, rank: int) -> tuple[int, int]:
    """``(position, count)`` of flat rank ``rank`` along ``axes`` (major to
    minor): the block of a dim split over ``axes`` that it holds."""
    sizes = mesh.shape
    names = mesh.axis_names
    order = tuple(n for n in names if n != "model") + (("model",) if "model" in names else ())
    coord, rest = {}, int(rank)
    for name in reversed(order):
        rest, coord[name] = divmod(rest, sizes[name])
    pos, count = 0, 1
    for name in _entry_axes(axes):
        pos = pos * sizes[name] + coord[name]
        count *= sizes[name]
    return pos, count


def block(x, spec, mesh: Mesh, rank: int):
    """The block of ``x`` (a tensor or numpy array) that rank ``rank``
    holds under ``spec`` (a ``PartitionSpec`` or a tuple of its entries): a
    view, each split dim cut to the rank's equal share (``x`` itself where
    nothing is split). A dim its axes do not divide raises, as an input
    sharding of the reference does."""
    if len(spec) > len(x.shape):
        raise ValueError(f"spec {tuple(spec)} has more entries than {tuple(x.shape)} has dims")
    index, split = [], False
    for dim, entry in enumerate(spec):
        pos, count = axis_position(mesh, entry, rank)
        n = x.shape[dim]
        if n % count:
            raise ValueError(f"dim {dim} of {n} does not split into {count} equal blocks")
        step = n // count
        index.append(slice(pos * step, (pos + 1) * step))
        split = split or count > 1
    return x[tuple(index)] if split else x


class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``'s counterpart. Not a
    dataclass, so that a tree of shardings has the shardings as leaves."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec):
        spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        for entry in spec:
            for a in _entry_axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"spec {spec} names axis {a!r}, not one of {mesh.axis_names}")
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of every rank's block of a tensor of ``shape``."""
        return tuple(self.block(torch.empty(tuple(shape), device="meta"), 0).shape)

    def block(self, x, rank: int):
        return block(x, self.spec, self.mesh, rank)

    def placed(self, x, rank: int) -> torch.Tensor:
        """Rank ``rank``'s block, a copy of its own in contiguous memory on
        the mesh's device."""
        return self.block(x, rank).to(self.mesh.device, copy=True,
                                      memory_format=torch.contiguous_format)

    def assemble(self, blocks) -> torch.Tensor:
        """The tensor of every rank's block (in the flat rank order)."""
        first = blocks[0]
        shape = list(first.shape)
        for dim, entry in enumerate(self.spec):
            shape[dim] *= math.prod(self.mesh.shape[a] for a in _entry_axes(entry))
        out = first.new_empty(shape)
        for r, b in enumerate(blocks):
            self.block(out, r).copy_(b)
        return out


def nbytes(tree, shardings) -> int:
    """One rank's bytes of ``tree``'s tensors (shapes and dtypes only, so
    ``meta`` tensors do) under ``shardings``, a tree of ``NamedSharding``s
    of the same structure. Every dim an input's spec splits divides, so
    every rank holds the same bytes."""
    return sum(math.prod(s.shard_shape(x.shape)) * x.element_size()
               for x, s in zip(leaves(tree), leaves(shardings), strict=True))


def place_tree(tree, shardings, group: Optional[dist.ProcessGroup] = None):
    """Place a (host-resident) tree of tensors on ``shardings`` (a tree of
    ``NamedSharding``s of the same structure, on one mesh): the list of
    every rank's tree of its blocks, each on the mesh's device, in the flat
    rank order (``group=None``, every rank in this process), or this rank's
    tree over ``group``, whose size must be the mesh's."""
    flat, treedef = flatten_with_paths(tree)
    shs = leaves(shardings)
    if len(shs) != len(flat) or not shs:
        raise ValueError(f"{len(flat)} leaves for {len(shs)} shardings")
    n = shs[0].mesh.size
    if group is None:
        return [unflatten(treedef, [s.placed(x, r) for (_, x), s in zip(flat, shs)])
                for r in range(n)]
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if world != n:
        raise ValueError(f"the process group has {world} ranks, the mesh {n}")
    return unflatten(treedef, [s.placed(x, rank) for (_, x), s in zip(flat, shs)])


def assemble_tree(rank_trees, shardings):
    """The inverse of ``place_tree``'s in-process placement: the tree of
    every rank's blocks reassembled."""
    per_rank = [leaves(t) for t in rank_trees]
    _, treedef = flatten_with_paths(rank_trees[0])
    return unflatten(treedef, [s.assemble([ls[i] for ls in per_rank])
                               for i, s in enumerate(leaves(shardings))])


def _right_align(spec_tail: tuple, ndim: int) -> P:
    """Pad a trailing-dims spec with None for any leading (stack) axes."""
    pad = ndim - len(spec_tail)
    return P(*((None,) * pad + tuple(spec_tail)))


# --------------------------------------------------------------------------
# rule tables: (regex on key path, trailing-dims logical spec)
# logical tokens: "model" | "data" | None
# --------------------------------------------------------------------------

# Each rule maps a path regex to a list of candidate trailing-dim layouts,
# in preference order; the first candidate whose sharded dims are all
# divisible by their axis sizes wins (jit *input* shardings must divide
# evenly — internal constraints may be uneven, inputs may not). Non-divisible
# dims inside the winning candidate degrade to None individually.
LM_RULES: list[tuple[str, list]] = [
    # vocab over model ONLY: sharding D (the logits contraction dim) over
    # data makes SPMD emit a [tokens, vocab]-sized partial-sum all-reduce
    # per loss chunk — measured 62 GB/step on gemma3 (EXPERIMENTS.md §Perf)
    (r"embed$", [("model", None)]),  # [V, D] vocab-sharded
    (r"unembed$", [(None, "model")]),  # [D, V]
    (r"(wq|wk|wv)$", [("data", "model")]),  # column-parallel
    (r"wo$", [("model", "data")]),  # row-parallel
    # MoE (before the dense FFN rules): prefer EP on the expert axis; if E
    # doesn't divide the model axis (granite: 40 experts / 16 chips), fall
    # back to TP on the expert-ff dim
    (r"moe.*(w_gate|w_up)$", [("model", "data", None), (None, "data", "model")]),
    (r"moe.*w_down$", [("model", None, "data"), (None, "model", "data")]),
    (r"(w_gate|w_up)$", [("data", "model")]),
    (r"w_down$", [("model", "data")]),
    (r"router$", [("data", None)]),
    (r"(scale|bias)$", [()]),  # norms replicated
    (r"pos_embed$", [()]),
]

GNN_RULES: list[tuple[str, list]] = [
    (r"w1$", [(None, "model")]),
    (r"w2$", [("model", None)]),
    (r"(b1|b2)$", [()]),
]

RECSYS_RULES: list[tuple[str, list]] = [
    # rows over EVERY axis: the table grad scatter + AdamW moments then shard
    # 256/512-ways (a model-only sharded 2B-row table's dense grad would blow
    # HBM); falls back to model-only for tiny test tables
    (r"table$", [("all", None), ("model", None), ()]),
    (r"wide$", [("all",), ("model",), ()]),  # row-sharded linear weights
    (r"pos_embed$", [()]),
    (r"(wq|wk|wv)$", [(None, "model")]),
    (r"wo$", [("model", None)]),
    (r"\.w$", [("data", "model"), (None, "model"), ()]),  # MLP / cross weights
    (r"\.b$", [()]),
    (r"(scale|bias)$", [()]),
]

RULES_BY_FAMILY = {"lm": LM_RULES, "gnn": GNN_RULES, "recsys": RECSYS_RULES}


def _resolve(token, axes: Axes):
    if token == "model":
        return axes.model
    if token == "data":
        return axes.data if len(axes.data) > 1 else axes.data[0]
    if token == "all":
        return axes.data + (axes.model,)
    return None


def _axis_size(token, axes: Axes, mesh_shape: dict) -> int:
    if token == "model":
        return mesh_shape[axes.model]
    if token == "data":
        n = 1
        for a in axes.data:
            n *= mesh_shape[a]
        return n
    if token == "all":
        n = 1
        for a in axes.data + (axes.model,):
            n *= mesh_shape[a]
        return n
    return 1


def _fits(tail: tuple, shape: tuple, axes: Axes, mesh_shape: dict) -> bool:
    off = len(shape) - len(tail)
    return all(
        shape[off + i] % _axis_size(t, axes, mesh_shape) == 0 for i, t in enumerate(tail)
    )


# Leaves smaller than this keep TP ('model') sharding but drop the
# FSDP/ZeRO 'data' dim: for small weights the all-gather/partial-reduce
# traffic SPMD emits outweighs the memory saved (measured: 62 GB/step of
# all-reduce on gemma3 train_4k before this guard). Large weights (yi-34b
# 7168x7168 = 205 MB) keep both axes — there ZeRO is what makes the
# optimizer state fit at all.
FSDP_MIN_BYTES = 32 * 1024 * 1024


def spec_for_path(
    path: str, shape: tuple, rules, axes: Axes, mesh_shape: dict, nbytes: int | None = None
) -> P:
    ndim = len(shape)
    for pat, candidates in rules:
        if not re.search(pat, path):
            continue
        usable = [c for c in candidates if len(c) <= ndim]
        if not usable:
            return P()
        tail = next((c for c in usable if _fits(c, shape, axes, mesh_shape)), None)
        if tail is None:  # best candidate, degrading non-divisible dims
            tail = usable[0]
            off = ndim - len(tail)
            tail = tuple(
                t if shape[off + i] % _axis_size(t, axes, mesh_shape) == 0 else None
                for i, t in enumerate(tail)
            )
        if nbytes is not None and nbytes < FSDP_MIN_BYTES:
            tail = tuple(None if t == "data" else t for t in tail)
        return _right_align(tuple(_resolve(t, axes) for t in tail), ndim)
    return P()  # default: replicated


def normalize_path(keystr_path: str) -> str:
    """``['blocks'][0]['attn']['wq']`` -> ``.blocks.0.attn.wq``."""
    return keystr_path.replace("'", "").replace("[", ".").replace("]", "")


def _leaf_specs(flat, rules, axes: Axes, mesh_shape: dict) -> list:
    """The spec of each ``(key path, tensor)``; the FSDP guard reads the
    tensor's bytes."""
    return [spec_for_path(normalize_path(path), tuple(leaf.shape), rules, axes, mesh_shape,
                          leaf.numel() * leaf.element_size()) for path, leaf in flat]


def _tree_specs(tree, rules, axes: Axes, mesh_shape: dict):
    flat, treedef = flatten_with_paths(tree)
    return unflatten(treedef, _leaf_specs(flat, rules, axes, mesh_shape))


def reference_leaf_paths(module: nn.Module) -> tuple[list, dict]:
    """The module's params in the reference's layout (``reference_tree``),
    as ``[(key path, meta tensor)]``, and for each of the module's parameter
    names the key path of the reference leaf it is a slice of.

    The module's own ``from_reference_tree`` does the slicing: it is handed,
    in place of each reference leaf, a stand-in of the leaf's shape whose
    every element is the leaf's number (a zero-stride view of one element,
    so a full-size leaf costs nothing), and each parameter it cuts out
    reads back the number of the leaf it came from."""
    named = {n: torch.empty_like(p, device="meta") for n, p in module.named_parameters()}
    flat, treedef = flatten_with_paths(module.reference_tree(named))
    codes = [torch.tensor(k).expand(tuple(leaf.shape)) for k, (_, leaf) in enumerate(flat)]
    sliced = module.from_reference_tree(unflatten(treedef, codes))
    return flat, {name: flat[int(t.as_strided((), ()).item())][0] for name, t in sliced.items()}


def param_specs(params, family: str, mesh: Mesh):
    """``PartitionSpec`` tree mirroring ``params`` (shapes only: ``meta``
    tensors do). A module that has the reference's layout
    (``reference_tree``) gets a dict keyed by its parameter names (as its
    optimizer moments are), each the spec of the reference leaf it is a
    slice of with the leading stack entries dropped (they are ``None``:
    specs are right-aligned); any other module the specs of its own
    ``named_parameters()``; a pytree of tensors the tree of their specs."""
    axes = mesh_axes(mesh)
    rules = RULES_BY_FAMILY[family]
    mesh_shape = dict(mesh.shape)
    if not isinstance(params, nn.Module):
        return _tree_specs(params, rules, axes, mesh_shape)
    named = dict(params.named_parameters())
    if not hasattr(params, "reference_tree"):
        return _tree_specs(named, rules, axes, mesh_shape)
    flat, paths = reference_leaf_paths(params)
    by_path = dict(zip((p for p, _ in flat), _leaf_specs(flat, rules, axes, mesh_shape)))
    out = {}
    for name, p in named.items():
        spec = by_path[paths[name]]
        drop = len(spec) - p.dim()
        if any(e is not None for e in spec[:drop]):
            raise ValueError(f"{name}: the stack axes of {paths[name]} are split ({spec})")
        out[name] = P(*spec[drop:])
    return out


def param_shardings(params, family: str, mesh: Mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), param_specs(params, family, mesh))


# --------------------------------------------------------------------------
# batch / cache / state shardings
# --------------------------------------------------------------------------


def batch_dim_sharding(mesh: Mesh, extra_dims: int = 1) -> NamedSharding:
    """Leading dim over all data axes, rest replicated: [B, ...]."""
    axes = mesh_axes(mesh)
    return NamedSharding(mesh, P(_resolve("data", axes), *((None,) * extra_dims)))


def fully_sharded_dim(mesh: Mesh, extra_dims: int = 0) -> NamedSharding:
    """Leading dim over ALL mesh axes (GNN edges, retrieval candidates)."""
    axes = mesh_axes(mesh)
    flat = axes.data + (axes.model,)
    return NamedSharding(mesh, P(flat, *((None,) * extra_dims)))


def batch_shardings(batch_specs: dict, mesh: Mesh, *, fully_shard: bool = False):
    """Shard every batch array on its leading dim (data axes, or all axes)."""

    def one(leaf):
        fn = fully_sharded_dim if fully_shard else batch_dim_sharding
        return fn(mesh, max(len(leaf.shape) - 1, 0))

    return tree_map(one, batch_specs)


def cache_shardings(cache_specs, mesh: Mesh):
    """KV cache: k/v [(R,) B, T, K, hd] -> batch over data, seq over model.

    Per-dim divisibility fallback (batch=1 long-context decode cannot shard
    its batch dim; 1k-slot ring buffers shard T only when it divides).
    """
    axes = mesh_axes(mesh)
    mesh_shape = dict(mesh.shape)

    def one(key, leaf):
        nd = len(leaf.shape)
        tail_tok = ("data", "model") if key.endswith("['pos']") else ("data", "model", None, None)
        off = nd - len(tail_tok)
        tok = tuple(
            t if t is None or leaf.shape[off + i] % _axis_size(t, axes, mesh_shape) == 0 else None
            for i, t in enumerate(tail_tok)
        )
        tail = tuple(_resolve(t, axes) for t in tok)
        return NamedSharding(mesh, _right_align(tail, nd))

    flat, treedef = flatten_with_paths(cache_specs)
    return unflatten(treedef, [one(key, leaf) for key, leaf in flat])


def train_state_shardings(abstract_state, family: str, mesh: Mesh):
    """TrainState shardings: opt moments mirror the param specs (ZeRO). For
    a module's state, ``params`` is the dict of its parameters' shardings,
    keyed as its moments are."""
    from repro_torch.train.optim import AdamWState
    from repro_torch.train.trainer import TrainState

    p_shard = param_shardings(abstract_state.params, family, mesh)
    return TrainState(
        params=p_shard,
        opt=AdamWState(m=p_shard, v=p_shard, count=NamedSharding(mesh, P())),
        step=NamedSharding(mesh, P()),
    )


def constraint(x, mesh: Optional[Mesh], *spec):
    """``with_sharding_constraint``'s counterpart: the port has no SPMD
    partitioner, and the reference's constraint changes no value, so ``x``
    is returned as it is."""
    return x


# --------------------------------------------------------------------------
# the ambient mesh (``use_mesh``: ``jax.set_mesh``'s counterpart). Model
# code reads the axis sizes (MoE's token groups); ``act`` changes no value.
# --------------------------------------------------------------------------

_AMBIENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh inside the ``with`` block."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def current_axes() -> Optional[Axes]:
    m = _AMBIENT.get()
    if m is None or "model" not in m.axis_names:
        return None
    return Axes(data=tuple(n for n in m.axis_names if n != "model"), model="model")


def ambient_axis_size(token: str) -> int:
    """Size of a logical axis group under the ambient mesh (1 if none)."""
    axes = current_axes()
    if axes is None:
        return 1
    shape = _AMBIENT.get().shape
    names = {"model": (axes.model,), "data": axes.data, "all": axes.data + (axes.model,)}[token]
    return math.prod(shape[a] for a in names)


def act(x, *logical):
    """Constrain an activation by logical dim tokens (``"data"``,
    ``"model"``, ``"all"`` or None): under the reference, a sharding
    constraint that changes no value; the port has no partitioner to hand
    it to, so ``x`` is returned as it is."""
    return x
