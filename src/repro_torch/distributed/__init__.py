"""Distribution layer: the mesh and its axes (a port of the part of
``repro.distributed`` that sharded serving uses; the parameter rules,
collectives and elastic meshes are not ported yet)."""
from repro_torch.distributed.sharding import Axes, Mesh, make_mesh, mesh_axes  # noqa: F401
