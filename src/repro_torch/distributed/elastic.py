"""Elastic scaling + straggler/failure handling, the port of
``repro.distributed.elastic``.

The recovery model:
  * **Training**: state lives in checkpoints (``repro_torch.checkpoint``).
    On node failure the job restarts on whatever survives; ``reshard_state``
    places the restored, host-resident state onto the *new* mesh's
    shardings: shard counts need not match (the checkpoint stores full
    logical arrays per leaf, host-side; resharding is a placement decision).
  * **Serving**: stateless: each device owns a doc shard of the impact
    index; losing a pod shrinks the corpus until re-shard, never corrupts
    results. The SAAT rho budget doubles as straggler mitigation: work per
    device is fixed by construction (``repro_torch.serving``).
  * **Liveness**: ``data_parallel_liveness`` is the sum-of-ones barrier used
    to detect and exclude failed data-parallel ranks between steps.

A mesh counts devices as the ranks of the default process group when one
is up, else as the visible CUDA devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh, make_mesh, place_tree, train_state_shardings
from repro_torch.train.optim import param_tree


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """Declarative mesh request; ``build`` degrades to the devices present."""

    pods: int
    data: int
    model: int

    def shape(self, multi_pod: bool) -> tuple:
        return (self.pods, self.data, self.model) if multi_pod else (self.data, self.model)

    def axis_names(self, multi_pod: bool) -> tuple:
        return ("pod", "data", "model") if multi_pod else ("data", "model")


def _device_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count()


def best_effort_mesh(topo: MeshTopology, *, multi_pod: bool = False, device=None) -> Mesh:
    """Build the requested mesh, shrinking the data axis if devices are lost.

    Elastic policy: the model axis is load-bearing (params are TP-sharded at
    a fixed degree) so it is preserved; lost capacity comes out of the
    data-parallel axes (smaller global batch, same model math). ``device``
    is the device the ranks run on (``make_mesh``).
    """
    n = _device_count()
    want = topo.shape(multi_pod)
    if n >= math.prod(want):
        return make_mesh(want, topo.axis_names(multi_pod), device=device)
    # shrink data axis to the largest degree that fits
    model = topo.model
    pods = topo.pods if multi_pod else 1
    data = max(1, n // (model * pods))
    shape = (pods, data, model) if multi_pod else (data, model)
    return make_mesh(shape, topo.axis_names(multi_pod), device=device)


def reshard_state(state: Any, family: str, new_mesh: Mesh,
                  group: Optional[dist.ProcessGroup] = None):
    """Place a (restored, host-resident) ``TrainState`` onto a new mesh's
    ``train_state_shardings``: the list of every rank's state of its blocks
    on the mesh's device (``group=None``), or this rank's over ``group``
    (``place_tree``). A module's params come as its ``named_parameters()``
    dict."""
    sh = train_state_shardings(state, family, new_mesh)
    return place_tree(dataclasses.replace(state, params=param_tree(state.params)), sh, group)


def data_parallel_liveness(mesh: Mesh, axis_name: str = "data",
                           group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Count live data-parallel ranks (barrier + census): an ``all_reduce``
    of ones over ``group`` (the ranks of ``axis_name``), int32 on the mesh's
    device; in process (``group=None``) every rank of the axis is live."""
    if group is None:
        return torch.tensor(mesh.shape[axis_name], dtype=torch.int32, device=mesh.device)
    ones = torch.ones((), dtype=torch.int32, device=mesh.device)
    dist.all_reduce(ones, op=dist.ReduceOp.SUM, group=group)
    return ones
