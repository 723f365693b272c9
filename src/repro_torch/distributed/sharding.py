"""Mesh axes for document-sharded serving.

The reference runs one SPMD program over a ``jax.sharding.Mesh``. The port
has no SPMD: its :class:`Mesh` is a small frozen description (axis names,
their sizes and the device the ranks run on), and the serve steps
(``repro_torch.serving.sharded``) run its ranks either all in this process,
one after another in the flat rank order, or one rank a process over a
``torch.distributed`` process group.

The flat rank order is row-major over ``mesh_axes(mesh).all``, the data
axes (``"pod"`` folded in) then ``"model"``: rank ``drank * n_model +
mrank``, the order in which the reference's partition specs lay out the
stacked shard axis and its tiled all-gathers concatenate.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


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
        n = 1
        for s in self.axis_sizes:
            n *= int(s)
        return n


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
