"""Whether what the timed path returned is right: a sample of its answers,
drawn from the seed, held against the plain reference.

Each answer is one request's top-k ids and scores (and, for SAAT, the
postings it processed). Against the reference's answer to the same query:

  * ``score_gap``: the widest gap, over every compared rank, between the
    served score and the reference's score at that rank, and between the
    served score and the reference's own score of the served doc, each
    over the row's best reference score. A served doc whose true score is
    not the score it was served with, or a top-k missing a better doc,
    opens it; a near-tie that summation order breaks either way does not.
  * ``bad_answers``: requests never answered, rows of the wrong length, a
    doc twice in one row, a non-finite score where the reference's is finite.
  * ``postings_off`` (SAAT): requests whose processed postings are not
    ``min(rho, total)``, the budget the configuration guarantees.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Served:
    """One answered request: its pool query, what the system returned."""

    query: int
    ids: np.ndarray
    scores: np.ndarray
    processed: Optional[int] = None


def sample(served: list, n: int, seed: int) -> list:
    rng = np.random.default_rng([int(seed), 7])
    if len(served) <= n:
        return list(served)
    return [served[i] for i in np.sort(rng.choice(len(served), size=n, replace=False))]


def row_numbers(got: Served, ref, k: int) -> tuple[float, int]:
    """``(score gap, bad)`` of one answer against the reference's."""
    ids = np.asarray(got.ids).astype(np.int64).reshape(-1)
    s = np.asarray(got.scores, dtype=np.float64).reshape(-1)
    if ids.size != k or s.size != k or np.unique(ids).size != k:
        return 0.0, 1
    if ((ids < 0) | (ids >= ref.acc.numel())).any():
        return 0.0, 1
    want = np.asarray(ref.scores, dtype=np.float64)
    if not np.isfinite(s).all():
        return float("inf"), 1
    true_of_served = ref.acc[torch.as_tensor(ids, device=ref.acc.device)].double().cpu().numpy()
    scale = float(np.abs(want).max()) if want.size and np.abs(want).max() > 0 else 1.0
    gap = max(float(np.abs(s - want).max()), float(np.abs(s - true_of_served).max()))
    return gap / scale, 0


def compare(served: list, reference, pool_terms, pool_weights, *, k: int, rho: Optional[int],
            n_missing: int = 0) -> dict:
    """The numbers compared, over ``served`` (already sampled)."""
    gap, bad, off = 0.0, int(n_missing), 0
    for a in served:
        ref = reference.search(pool_terms[a.query], pool_weights[a.query], k, rho)
        g, b = row_numbers(a, ref, k)
        gap, bad = max(gap, g), bad + b
        if rho is not None and (a.processed is None or int(a.processed) != ref.processed):
            off += 1
    out = {"score_gap": gap, "bad_answers": bad}
    if rho is not None:
        out["postings_off"] = off
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number within its limit; ``checks`` maps
    each name to its number and limit, and is printed last on stderr."""
    checks = {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def print_checks(correct: bool, checks: dict) -> None:
    parts = [f"{n}={c['value']!r} (limit {c['limit']!r})" for n, c in checks.items()]
    print(f"correct={correct}: " + ", ".join(parts), file=sys.stderr, flush=True)
