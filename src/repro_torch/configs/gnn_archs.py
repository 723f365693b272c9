"""GraphCast arch config (encode-process-decode mesh GNN): the port of
``repro.configs.gnn_archs``, with torch dtypes.

The paper's technique (impact-quantized vocab-space retrieval) is NOT
applicable to a weather GNN — no bag-of-words scoring exists anywhere in
encode-process-decode; documented in DESIGN.md §4. The arch is implemented
in full *without* the technique and shares the generic substrate (trainer,
checkpointing, sharding, and the segment_sum machinery that also backs the
recsys EmbeddingBag).

``d_feat`` varies by assigned shape (input feature width of each dataset);
the processor (16 x 512, sum aggregator, 227 output vars) is the published
GraphCast configuration and never changes.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.archs.gnn import GNNConfig
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, gnn_cells

GRAPHCAST = GNNConfig(
    name="graphcast",
    n_layers=16,
    d_hidden=512,
    aggregator="sum",
    n_vars=227,
    mesh_refinement=6,
)


def _config_for(shape: str) -> GNNConfig:
    dims = GNN_SHAPES[shape]
    # bf16 compute: the dominant cost is moving the [N, 512] node array
    # through gathers/scatters every layer (unpartitioned message passing is
    # all-to-all by nature) — bf16 halves those bytes (§Perf #6)
    return dataclasses.replace(
        GRAPHCAST,
        d_feat=dims["d_feat"],
        graph_readout=(shape == "molecule"),
        dtype=torch.bfloat16,
    )


def _smoke() -> GNNConfig:
    return dataclasses.replace(
        GRAPHCAST, n_layers=2, d_hidden=32, n_vars=5, d_feat=16, mesh_refinement=1
    )


SPECS = {
    "graphcast": ArchSpec(
        arch_id="graphcast",
        family="gnn",
        source="arXiv:2212.12794; unverified",
        config_for=_config_for,
        smoke_config=_smoke,
        cells=gnn_cells(),
    )
}
