"""Pytrees of tensors for the trainer, the optimizer and checkpoints.

A pytree is a nest of dicts, lists, tuples, named tuples, dataclasses and
``None`` (no leaves) around leaves. It is flattened in JAX's order (a
dict's keys sorted) and each leaf is named by JAX's key path (``['key']``,
``[i]``, ``.field``), so a checkpoint's manifest names every leaf as the
reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

_LEAF = None


def _node(tree) -> tuple[list, tuple] | None:
    """(children as (key, child), rebuild info), or None for a leaf."""
    if tree is None:
        return [], ("none", None, None)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [(f"[{k!r}]", tree[k]) for k in keys], ("dict", type(tree), keys)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields], ("namedtuple", type(tree), None)
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)], ("seq", type(tree), None)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return [(f".{n}", getattr(tree, n)) for n in names], ("dataclass", type(tree), names)
    return None


def flatten_with_paths(tree) -> tuple[list[tuple[str, Any]], Any]:
    """([(key path, leaf)], treedef)."""
    out: list = []

    def walk(node, path):
        split = _node(node)
        if split is None:
            out.append((path, node))
            return _LEAF
        kids, info = split
        return info, [walk(child, path + key) for key, child in kids]

    return out, walk(tree, "")


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def build(td):
        if td is _LEAF:
            return next(it)
        (kind, typ, aux), kids = td
        vals = [build(k) for k in kids]
        if kind == "none":
            return None
        if kind == "dict":
            return typ(zip(aux, vals))
        if kind == "namedtuple":
            return typ(*vals)
        if kind == "seq":
            return typ(vals)
        return typ(**dict(zip(aux, vals)))

    return build(treedef)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)[0]]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of each of ``rest`` (same
    structure), rebuilt in ``tree``'s structure."""
    flat, treedef = flatten_with_paths(tree)
    others = [leaves(r) for r in rest]
    for other in others:
        if len(other) != len(flat):
            raise ValueError("pytrees differ in structure")
    return unflatten(treedef, [fn(leaf, *xs) for (_, leaf), *xs in zip(flat, *others)])


def nest_names(named: dict) -> Any:
    """Dotted names to a nest: ``{"a.0.w": x, "b": y}`` ->
    ``{"a": [{"w": x}], "b": y}``; a level whose parts are all numbers is a
    list in their order."""
    root: dict = {}
    for name, value in named.items():
        node = root
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def dotted_names(tree, prefix: str = "") -> dict:
    """The inverse of ``nest_names``: a nest of dicts and lists -> dotted
    name -> leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict = {}
    for key, value in items:
        nested = isinstance(value, (dict, list, tuple))
        out.update(dotted_names(value, f"{prefix}{key}." if nested else f"{prefix}{key}"))
    return out
