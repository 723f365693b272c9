"""The production meshes, the port of ``repro.launch.mesh``.

The reference's production meshes are TPU pods of 16x16 = 256 chips, and two
pods stacked on a leading ``pod`` axis (512 chips); the ``pod`` axis joins
the data-parallel group (gradient sync crosses the pod boundary; model
parallelism stays inside a pod). The port builds the same shapes and names,
so that its plans compare with the reference's. A port ``Mesh`` is a
description: building one allocates nothing and needs no 256 devices.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_for(name: str, device=None) -> Mesh:
    if name in ("single", "single_pod", "16x16"):
        return make_production_mesh(multi_pod=False, device=device)
    if name in ("multi", "multi_pod", "2x16x16"):
        return make_production_mesh(multi_pod=True, device=device)
    raise ValueError(f"unknown mesh {name!r} (use 'single' or 'multi')")


def n_chips(mesh: Mesh) -> int:
    return mesh.size
