"""Arch registry: 10 assigned architectures (the port of
``repro.configs``).

``--arch <id>`` anywhere in the launchers resolves through ``ARCHS``.
"""
from repro_torch.configs.base import (  # noqa: F401
    ArchSpec,
    Cell,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    batch_specs,
)
from repro_torch.configs import gnn_archs, lm_archs, recsys_archs

ARCHS: dict = {}
ARCHS.update(lm_archs.SPECS)
ARCHS.update(gnn_archs.SPECS)
ARCHS.update(recsys_archs.SPECS)


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch, shape) pair, including documented skips."""
    out = []
    for aid, spec in ARCHS.items():
        for cell in spec.cells.values():
            out.append((aid, cell))
    return out
