"""The four assigned recsys architectures (exact published interaction
configs): the port of ``repro.configs.recsys_archs``.

Embedding-table row counts follow the 10^6-10^9 guidance with a realistic
skew (a few huge id spaces, many small) — the tables are the memory object
the row-sharding design exists for. The paper's technique applies to the
*scoring role*: ``retrieval_cand`` is exactly the top-k-under-budget problem
(Eq. 1 for the additive wide part), sharing the top-k kernels (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses

from repro_torch.archs.embedding import TableSpec, criteo_like_rows
from repro_torch.archs.recsys import RecsysConfig
from repro_torch.configs.base import ArchSpec, recsys_cells

DCN_V2 = RecsysConfig(
    name="dcn-v2",
    kind="dcn-v2",
    table=TableSpec(criteo_like_rows(26, big=10_000_000, medium=1_000_000, small=100_000), 16),
    n_dense=13,
    n_cross_layers=3,
    mlp_dims=(1024, 1024, 512),
)

DIN = RecsysConfig(
    name="din",
    kind="din",
    table=TableSpec((10_485_760,), 18),  # item/goods id space (10 * 2^20 rows)
    attn_mlp_dims=(80, 40),
    mlp_dims=(200, 80),
    seq_len=100,
)

SASREC = RecsysConfig(
    name="sasrec",
    kind="sasrec",
    table=TableSpec((3_145_728,), 50),  # 3 * 2^20 item rows
    n_blocks=2,
    n_heads=1,
    seq_len=50,
)

WIDE_DEEP = RecsysConfig(
    name="wide-deep",
    kind="wide-deep",
    table=TableSpec(criteo_like_rows(40, big=10_000_000, medium=1_000_000, small=50_000, seed=1), 32),
    mlp_dims=(1024, 512, 256),
)


def _smoke_table(cfg: RecsysConfig) -> RecsysConfig:
    small = TableSpec(tuple(min(r, 200) for r in cfg.table.slot_rows), cfg.table.dim)
    reduced = dataclasses.replace(cfg, table=small)
    if cfg.kind in ("din", "sasrec"):
        reduced = dataclasses.replace(reduced, seq_len=min(cfg.seq_len, 12))
    if cfg.mlp_dims:
        reduced = dataclasses.replace(reduced, mlp_dims=tuple(min(d, 64) for d in cfg.mlp_dims))
    return reduced


def _spec(cfg: RecsysConfig, source: str) -> ArchSpec:
    return ArchSpec(
        arch_id=cfg.name,
        family="recsys",
        source=source,
        config_for=lambda shape, _c=cfg: _c,
        smoke_config=lambda _c=cfg: _smoke_table(_c),
        cells=recsys_cells(),
    )


SPECS = {
    "dcn-v2": _spec(DCN_V2, "arXiv:2008.13535; paper"),
    "din": _spec(DIN, "arXiv:1706.06978; paper"),
    "sasrec": _spec(SASREC, "arXiv:1808.09781; paper"),
    "wide-deep": _spec(WIDE_DEEP, "arXiv:1606.07792; paper"),
}
