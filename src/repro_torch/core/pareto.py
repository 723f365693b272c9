"""Effectiveness/efficiency Pareto frontier (paper Figure 3).

The port of ``repro.core.pareto``: plain Python, a copy that differs from
the original only in this docstring.

A configuration (retrieval model x system x operating point) is on the
frontier iff no other configuration has both higher effectiveness and lower
mean latency. The paper's headline observation: *every* retrieval model is
Pareto-optimal under some system, and PISA(DAAT) / JASS-approx(SAAT) share the
frontier.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    name: str  # e.g. "splade/saat-rho=5m"
    model: str
    system: str
    effectiveness: float  # e.g. mean RR@10 (higher better)
    latency_ms: float  # mean query latency (lower better)
    extra: dict = dataclasses.field(default_factory=dict)


def pareto_frontier(points: Sequence[OperatingPoint]) -> list[OperatingPoint]:
    """Non-dominated subset, sorted by latency ascending."""
    pts = sorted(points, key=lambda p: (p.latency_ms, -p.effectiveness))
    frontier: list[OperatingPoint] = []
    best_eff = float("-inf")
    for p in pts:
        if p.effectiveness > best_eff:
            frontier.append(p)
            best_eff = p.effectiveness
    return frontier


def dominated_by(p: OperatingPoint, points: Sequence[OperatingPoint]) -> list[OperatingPoint]:
    """All points that dominate p (strictly better on one axis, >= on both)."""
    out = []
    for q in points:
        if q is p:
            continue
        if (
            q.effectiveness >= p.effectiveness
            and q.latency_ms <= p.latency_ms
            and (q.effectiveness > p.effectiveness or q.latency_ms < p.latency_ms)
        ):
            out.append(q)
    return out


def frontier_table(points: Sequence[OperatingPoint]) -> list[dict]:
    frontier = set(id(p) for p in pareto_frontier(points))
    rows = []
    for p in sorted(points, key=lambda p: p.latency_ms):
        rows.append(
            {
                "name": p.name,
                "model": p.model,
                "system": p.system,
                "effectiveness": round(p.effectiveness, 4),
                "latency_ms": round(p.latency_ms, 3),
                "pareto": id(p) in frontier,
                **p.extra,
            }
        )
    return rows
